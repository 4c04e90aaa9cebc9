"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's timing tools (``tools/time_*.py``) never import ``jax`` or anything
of the reference package ``repro``."""
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
dist, _, overflow = B.run_distributed(QUERIES[10], db, 2, device="cpu")
want, _ = B.run_reference(QUERIES[10], db)
assert not overflow and len(dist["revenue"]) == len(want["revenue"])
from repro_torch.distributed import checkpoint, lineage
from repro_torch.distributed.chaos import ChaosInjector, FaultPlan
from repro_torch.distributed.fault import QueryRunner, RetryPolicy
from repro_torch.sql import compile_sql, sql_queries
runner = QueryRunner(db, 2, device="cpu",
                     chaos=ChaosInjector(FaultPlan.default(11)),
                     policy=RetryPolicy(max_attempts=6, backoff_s=0.0))
res = runner.run(sql_queries()[10])
assert res.report.outcomes() == ["transient", "corrupt", "overflow", "ok"]
assert [len(res.result[k]) for k in res.result] == \
    [len(want["revenue"])] * len(res.result)
import dataclasses
import torch
from repro_torch import configs
from repro_torch.launch import serve_lm
from repro_torch.models import Model
cfg = dataclasses.replace(configs.get_config("mistral_nemo_12b").reduced(),
                          n_kv_heads=2)
model = Model(cfg, device="cpu", dtype=torch.float32, use_flash_kernel=True)
gen = serve_lm.generate(model, torch.zeros((1, 4), dtype=torch.int64), 3,
                        1.0, torch.Generator().manual_seed(0))
assert gen.tokens.shape == (1, 3)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("time_*.py"))
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the scan itself catches what it must and spares the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import table")
    assert not _FORBIDDEN.search("from repro_torch.core import table")
