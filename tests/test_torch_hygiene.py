"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` never
import ``jax`` or anything of the reference package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\.|\s|,|$)|from\s+(jax|jaxlib|repro)(\.|\s))",
    re.M)


def _run(code: str, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def test_port_runs_with_jax_and_reference_blocked():
    code = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
sys.modules["repro"] = None        # and so does any `import repro...`
from repro_torch.core import backend as B
from repro_torch.data import tpch
from repro_torch.queries import QUERIES
db = tpch.generate(0.002, seed=11)
out, stats = B.run_local(QUERIES[6], db, device="cpu")
want, _ = B.run_reference(QUERIES[6], db)
assert abs(float(out["revenue"][0]) - float(want["revenue"][0])) <= \\
    1e-7 * abs(float(want["revenue"][0]))
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the scan itself catches what it must and spares the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import table")
    assert not _FORBIDDEN.search("from repro_torch.core import table")


def test_sql_frontend_refuses_until_ported():
    res = _run("import repro_torch.queries", REPRO_FRONTEND="sql")
    assert res.returncode != 0
    assert "NotImplementedError" in res.stderr and "A8" in res.stderr
