"""The port's LM dry-run (repro_torch.launch.dryrun, configs.input_specs,
bench/bench_roofline.py) against the reference's (repro.launch.dryrun,
repro.configs, benchmarks/bench_roofline.py).

``input_specs`` must give the reference's shapes and dtypes for every cell.
The dry-run itself runs reduced cells on a fake group of 2 x 2 ranks in a
subprocess (the fake group is process-wide state): each record has the
reference's keys or names them in ``not_reported``; its argument bytes are
the local bytes of rank 0's shards of the parameters, the optimizer state
and the inputs, summed here independently; and its counts (traced at one
or two layers of each kind and extrapolated to the cell's depth, each SSM
time loop weighted) equal a direct trace of every layer and step exactly,
FLOPs, traffic and collectives: runs of 5 and 6 layers, the hybrid's
shared block, and SSM time loops of 128 steps, in train, prefill and
decode.  The direct trace is the dry-run's own with its plan and its loop
weighting replaced here by a single trace and the plain loop.  On a batch
of 4, the per-device FLOPs of the multi-pod mesh (2, 2, 2) are half those
of (2, 2), which has half the data ranks.  ``bench_roofline`` must print
the reference's lines on the same records.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

from repro import configs as ref_configs

from repro_torch import configs

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, depth) of the reduced cells: depths extrapolated from one
# or two layers (DeepSeek-V2's first is dense; Zamba2's shared block runs
# between segments of 2), time loops weighted (128 steps), train with
# remat, prefill and decode, GQA, MoE with MLA, Mamba2 and RWKV6
CELLS = [("mistral_nemo_12b", "train_4k", 5),
         ("deepseek_v2_236b", "decode_32k", 6),
         ("rwkv6_3b", "prefill_32k", None),
         ("zamba2_1_2b", "train_4k", 5)]
# (arch, shape) held on the multi-pod mesh against (2, 2)
MULTI_POD = [("qwen1_5_110b", "prefill_32k"), ("mistral_nemo_12b",
                                                "train_4k")]
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "memory",
            "collective_bytes", "collective_count", "roofline", "ok"}

_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.launch import dryrun as D
from repro_torch.distributed import shardings as sh
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, ssm

def local_bytes(t):
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.numel() * t.element_size()

def argument_bytes(cfg, shape, mesh):
    # rank 0's shards, summed from the model, not from the record
    model = Model(cfg, device="meta", dtype=torch.bfloat16, expert_pad=2,
                  vocab_pad=128)
    axes = sh.MeshAxes()
    sh.distribute_model(model, mesh, axes)
    total = sum(local_bytes(p) for p in model.parameters())
    inputs = input_specs(cfg, shape, True)
    if "labels" in inputs:                 # train: float32 m and v, step
        total += 2 * sum(p.to_local().numel() * 4
                         for p in model.parameters()) + 4
    if "token" in inputs:                  # decode: the cache, the position
        cache = model.init_cache(2, 128, dtype=torch.bfloat16)
        specs = sh.cache_specs(cfg, cache, axes, 2, {"data": 2, "model": 2})
        cache = sh.distribute_tree(cache, specs, mesh)
        from torch.utils._pytree import tree_leaves
        total += sum(local_bytes(t) for t in tree_leaves(cache)) + 4
    for k, v in inputs.items():            # batch over data
        total += local_bytes(sh.shard_like(
            v, mesh, sh.Spec("data", *([None] * (v.ndim - 1)))))
    return total

PLAIN_SCAN = ssm.scan

def direct(cfg, shape, mesh):
    # every layer traced (no plan) and every time step (the plain loop)
    plan, scan = D.plan, D.OpCounter.scan
    D.plan = lambda c: [(c, 1)]
    D.OpCounter.scan = lambda self, step, carry, n: PLAIN_SCAN(step, carry,
                                                                n)
    try:
        return D.cell_record(cfg, shape, mesh, D.Options(), reduced=True)
    finally:
        D.plan, D.OpCounter.scan = plan, scan

def flops_at_batch_4(cfg, shape, mesh_shape):
    D.start_fake_group(8 if len(mesh_shape) == 3 else 4)
    mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):],
                     "cpu")
    seq, _, kind = SHAPES[shape]
    inputs = {k: torch.empty((4,) + tuple(v.shape[1:]), dtype=v.dtype,
                             device="meta")
              for k, v in input_specs(cfg, shape, True).items()}
    return D.counts(cfg, kind, inputs, min(seq, 128), mesh,
                    D.Options())[0]["flops"]

out = {}
D.start_fake_group(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
for arch, shape, layers in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rec = D.cell_record(cfg, shape, mesh, D.Options(), reduced=True)
    out[f"{arch}:{shape}"] = {
        "record": {"arch": arch} | rec, "direct": direct(cfg, shape, mesh),
        "argument_bytes": argument_bytes(cfg, shape, mesh)}
# every (2, 2) run before the group of 8 (a group replaced mid-run leaves
# DTensor's caches holding the old one)
for mesh_shape in ((2, 2), (2, 2, 2)):
    for arch, shape in json.loads(sys.argv[2]):
        out.setdefault(f"multi_pod:{arch}:{shape}", {})[
            "x".join(map(str, mesh_shape))] = flops_at_batch_4(
                get_config(arch).reduced(), shape, mesh_shape)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(CELLS),
                          json.dumps(MULTI_POD)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape, reduced):
    want = ref_configs.input_specs(ref_configs.get_config(arch), shape,
                                   reduced)
    got = configs.input_specs(configs.get_config(arch), shape, reduced)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == jnp.dtype(want[k].dtype).name


def test_cells_and_their_order_are_the_reference_s():
    from repro_torch.launch import dryrun
    cells = list(dryrun.iter_cells(True))
    enabled = [(a, s) for a, s, mp, why in cells if not why]
    want = [(a, s) for a, s, ok, _ in ref_configs.iter_cells() if ok]
    assert enabled == want + want
    assert [(a, s) for a, s, mp, why in cells if why] == \
        [(a, s) for a, s, ok, _ in ref_configs.iter_cells() if not ok]
    assert [mp for *_, mp, why in cells if not why] == \
        [False] * len(want) + [True] * len(want)
    assert dryrun.model_flops(configs.get_config("qwen1_5_110b"),
                              "train_4k", 256, 4096) == \
        6.0 * configs.get_config("qwen1_5_110b").param_count * 256 * 4096


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in CELLS])
def test_record_has_the_reference_keys(records, cell):
    rec = records[cell]["record"]
    assert rec["ok"] is True
    assert REF_KEYS <= set(rec)
    assert {"flops", "traffic_bytes", "loops", "traces",
            "not_reported"} <= set(rec)
    assert set(rec["not_reported"]) == {
        "compile_s", "generated_code_bytes", "cost_analysis_flops",
        "cost_analysis_bytes", "op_histogram", "hlo_len"}
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    assert rec["flops"] > 0 and rec["traffic_bytes"] > 0
    assert set(rec["collective_count"]) <= {"all-gather", "all-reduce",
                                            "reduce-scatter", "all-to-all"}
    assert rec["roofline"]["cluster"] == "h100_ib"
    assert rec["memory"]["temp_bytes"] is None


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in CELLS])
def test_argument_bytes_are_the_local_shards(records, cell):
    got = records[cell]
    assert got["record"]["memory"]["argument_bytes"] == \
        got["argument_bytes"]


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in CELLS])
def test_weighted_count_equals_the_direct_trace(records, cell):
    w, d = records[cell]["record"], records[cell]["direct"]
    for key in ("flops", "traffic_bytes", "collective_count",
                "collective_bytes"):
        assert w[key] == d[key], key
    assert w["memory"] == d["memory"]
    # the counts came from short traces
    assert d["traces"] == 1 and w["traces"] >= 1


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in MULTI_POD])
def test_multi_pod_halves_the_flops_of_a_device(records, cell):
    """Twice the data ranks (pod x data = 4 against 2) on the same batch:
    each device computes half, as the reference's plan does (nothing is
    replicated over the flattened pod and data dims)."""
    got = records[f"multi_pod:{cell}"]
    assert 2 * got["2x2x2"] == got["2x2"], got


def _load_ref_bench_roofline():
    path = ROOT / "benchmarks" / "bench_roofline.py"
    sys.path.insert(0, str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location(
            "benchmarks.bench_roofline", path,
            submodule_search_locations=None)
        mod = importlib.util.module_from_spec(spec)
        mod.__package__ = "benchmarks"
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_bench_roofline_prints_the_reference_lines(records, tmp_path,
                                                   capsys, monkeypatch):
    from repro_torch.bench import bench_roofline
    cells = {k: v for k, v in records.items()
             if not k.startswith("multi_pod:")}
    for name, rec in cells.items():
        with open(tmp_path / f"{name.replace(':', '__')}.json", "w") as f:
            json.dump(rec["record"], f)
    skipped = {"ok": False, "skipped": "full-attention arch: 524k decode "
               "skipped (DESIGN.md §5)", "arch": "gemma_7b",
               "shape": "long_500k", "mesh": "16x16"}
    failed = {"ok": False, "error": "RuntimeError: out of memory",
              "arch": "qwen1_5_110b", "shape": "prefill_32k",
              "mesh": "2x16x16"}
    for i, rec in enumerate((skipped, failed)):
        with open(tmp_path / f"z{i}.json", "w") as f:
            json.dump(rec, f)
    bench_roofline.main(["--results", str(tmp_path)])
    got = capsys.readouterr().out
    ref = _load_ref_bench_roofline()
    monkeypatch.setattr(ref, "RESULTS", str(tmp_path))
    ref.main()
    want = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == len(cells) + 2
    assert "bottleneck=" in got and "skipped:" in got and "FAILED:" in got


def test_bench_roofline_without_records(tmp_path, capsys):
    from repro_torch.bench import bench_roofline
    assert bench_roofline.main(["--results", str(tmp_path)]) == []
    assert capsys.readouterr().out.startswith("roofline_missing,0.0,")
