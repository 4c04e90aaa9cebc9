"""Import hygiene of the port: ``repro_torch`` (its serving and
approximate layers, the SF 1000 dry-run, every model family and the
training path included), ``chip_smoke.py``, the port's examples
(``examples/torch_*.py``), its timing tools (``tools/time_*.py``) and
``tools/compare_dryrun.py`` never import ``jax`` or anything of the
reference package ``repro``; every
example resolves its device through ``core/table.py::resolve_device``,
``cuda`` unless asked for another."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\.|\s|,|$)|from\s+(jax|jaxlib|repro)(\.|\s))",
    re.M)


_EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


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
from repro_torch import approx
from repro_torch.launch import report
from repro_torch.serve import QueryServer, TEMPLATES
srv = QueryServer(db, device="cpu")
q6 = srv.submit(6, {"q6_qty": 25})
bound, _ = B.run_local(TEMPLATES[6].bind(q6_qty=25), db, device="cpu")
assert q6["revenue"].tobytes() == bound["revenue"].tobytes()
est = srv.submit(1, tolerance=0.5)
assert srv.approx_served == 1 and len(est["sum_qty"]) > 0
assert approx.ProgressiveRunner(db, device="cpu", tolerance=0.0).run(
    QUERIES[6]).exact
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
# the MoE (MLA, GQA), Mamba2-hybrid and RWKV6 families (models/moe.py,
# models/ssm.py): prefill and decode through the counting-rank dispatch
for arch in ("deepseek_v2_236b", "granite_moe_3b_a800m", "zamba2_1_2b",
             "rwkv6_3b"):
    model = Model(configs.get_config(arch).reduced(), device="cpu",
                  dtype=torch.float32)
    gen = serve_lm.generate(model, torch.zeros((1, 4), dtype=torch.int64),
                            2, 1.0, torch.Generator().manual_seed(0))
    assert gen.tokens.shape == (1, 2), arch
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "tools" / "compare_dryrun.py"] + \
        sorted((ROOT / "tools").glob("time_*.py")) + _EXAMPLES
    assert len(files) > 15 and len(_EXAMPLES) == 7
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the scan itself catches what it must and spares the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import table")
    assert not _FORBIDDEN.search("from repro_torch.core import table")


_BENCHMARKS = re.compile(r"^\s*(import|from)\s+benchmarks(\.|\s|,|$)", re.M)


def test_benches_import_no_reference_benchmarks():
    files = sorted((ROOT / "src" / "repro_torch" / "bench").glob("*.py"))
    # the 13 benches, bench_roofline, common.py and run.py, beside
    # __init__.py
    assert len(files) == 17
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for pat in (_FORBIDDEN, _BENCHMARKS)
           for m in pat.finditer(f.read_text())]
    assert not bad, bad
    assert _BENCHMARKS.search("from benchmarks import bench_tpch")
    assert not _BENCHMARKS.search("from repro_torch.bench import run")


def test_benches_run_with_jax_reference_and_benchmarks_blocked(tmp_path):
    code = f"""
import importlib
import sys
for name in ("jax", "jaxlib", "repro", "benchmarks"):
    sys.modules[name] = None       # any import of them now raises
from repro_torch.bench import run
for name in run.ORDER:
    importlib.import_module("repro_torch.bench." + name)
secs = run.run(["bench_exchange_bytes"], "cpu", out_dir={str(tmp_path)!r},
               check=True)
assert list(secs) == ["bench_exchange_bytes"]
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "repro", "benchmarks")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert (tmp_path / "bench_exchange_bytes.json").is_file()


@pytest.mark.parametrize("path", _EXAMPLES, ids=lambda p: p.stem)
def test_example_resolves_its_device(path):
    text = path.read_text()
    assert "resolve_device(args.device)" in text
    assert 'ap.add_argument("--device", default="cuda")' in text


def test_training_runs_with_jax_and_reference_blocked(tmp_path):
    """The trainer (``launch/train.py``), the optimizer and train step
    (``train/``), the loss and remat: two smoke steps, a checkpoint and its
    restore, and the example's three steps, with jax and repro blocked."""
    code = f"""
import importlib.util
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import torch
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.train import optimizer, trainstep
args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "8",
        "--ckpt-dir", {str(tmp_path / "a")!r}, "--ckpt-every", "2"]
out = train.main(args + ["--steps", "2"])
assert out["steps"] == [1, 2]
assert train.main(args + ["--steps", "1"])["steps"] == [3]
cfg = configs.get_config("zamba2_1_2b").reduced()
model = Model(cfg, device="cpu", dtype=torch.float32, remat="full")
step = trainstep.make_train_step(model, optimizer.AdamWConfig(), "int8_ef", 2)
state = trainstep.init_train_state(model, "int8_ef")
tokens = torch.zeros((2, 8), dtype=torch.int64)
m = step(state, {{"tokens": tokens, "labels": tokens}})
assert sorted(m) == ["ce", "drop_frac", "grad_norm", "lb_loss", "loss", "lr"]
spec = importlib.util.spec_from_file_location(
    "ex", {str(ROOT / "examples" / "torch_train_lm.py")!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
losses = mod.main(["--steps", "3", "--batch", "2", "--seq", "8", "--device",
                   "cpu", "--ckpt-dir", {str(tmp_path / "b")!r}])
assert list(losses) == [1]
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_dryrun_and_examples_run_with_jax_and_reference_blocked(tmp_path):
    code = f"""
import importlib.util
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
from repro_torch.launch import dryrun_analytics
recs = dryrun_analytics.main(["--queries", "9,13", "--out", {str(tmp_path)!r}])
assert [r["plan"]["shuffles"] for r in recs] == [1, 1]
for path in {[str(p) for p in _EXAMPLES]!r}:
    spec = importlib.util.spec_from_file_location("ex", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
mod = importlib.util.module_from_spec(importlib.util.spec_from_file_location(
    "qs", {str(ROOT / "examples" / "torch_quickstart.py")!r}))
mod.__spec__.loader.exec_module(mod)
out = mod.main(["--sf", "0.002", "--device", "cpu"])
assert out["q1_flags"] == ["A", "N", "N", "R"]
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert (tmp_path / "q9_256.json").is_file()
