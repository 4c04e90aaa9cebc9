"""The port's sharded plan against the reference's, work per device (ROADMAP
fault C9): one reduced cell of each class of that fault, lowered by both
packages on the same small mesh, the reference's ``repro.launch.dryrun``
in one subprocess and the port's ``repro_torch.launch.dryrun`` in another
(each process holds its own fake devices or fake group), both started at
once.

The classes, on reduced configs at batch 8 (the multi-pod mesh needs a
batch that pod x data divides):

* ``decode``: a decode step whose batch the data axis cuts (Phi-3, 2 x 2):
  the query's pending sum over the data axis is reduced onto the cache's
  batch shards, and the cache is never gathered;
* ``heads``: six heads over a model axis of four (two KV heads; Granite's
  MoE with its attention, a train step on 2 x 4): each rank computes its
  share, as XLA spreads it, not every head;
* ``moe``: DeepSeek-V2's MLA and MoE (prefill, 2 x 2): MLA's query is not
  gathered, and no rank gathers every token for its experts;
* ``multi_pod``: Gemma's four heads on (pod 2, data 4, model 2), whose
  flattened pod x data dim of eight does not divide the heads but does not
  cut them either.

Each asserts the port's FLOPs per device at most ``FLOPS_LIMIT`` times the
reference's ``hlo_flops`` and its collective bytes per device at most the
reference's; before the fix the four read 1.07x, 1.80x, 1.12x and 1.17x.
A direct test of ``models.common.on_shards`` with a query holding a pending
sum (its batch whole) and a cache cut on its batch, on a fake group of
four, asserts the reduce-scatter of the query and no all-gather at all;
another, with keys cut on their sequence, that the softmax is reduced over
the keys' shards only where no gradient is taken (its collectives have no
backward), and that the keys are gathered where one is.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FLOPS_LIMIT = 1.01
BATCH = 8
# name -> (arch, shape, mesh, config overrides)
CELLS = {
    "decode": ("phi3_mini_3_8b", "decode_32k", (2, 2), {}),
    "heads": ("granite_moe_3b_a800m", "train_4k", (2, 4),
              {"n_heads": 6, "n_kv_heads": 2}),
    "moe": ("deepseek_v2_236b", "prefill_32k", (2, 2), {}),
    "multi_pod": ("gemma_7b", "prefill_32k", (2, 4, 2), {}),
}

_REF = r"""
import dataclasses, json, math, sys, tempfile
import repro.launch.dryrun as RD          # sets the host device count first
import jax
import numpy as np
from jax.sharding import Mesh
from repro import configs
out = {}
with tempfile.TemporaryDirectory() as tmp:
    RD.RESULTS = tmp                      # its HLO dumps go there
    for name, (arch, shape, mesh_shape, over) in json.loads(
            sys.argv[1]).items():
        cfg = dataclasses.replace(configs.get_config(arch).reduced(), **over)
        seq, _, kind = configs.SHAPES[shape]
        devs = np.asarray(jax.devices()[:math.prod(mesh_shape)])
        axes = ("pod", "data", "model")[-len(mesh_shape):]
        RD.make_production_mesh = lambda multi_pod=False, tp=16: Mesh(
            devs.reshape(mesh_shape), axes)
        RD.get_config = lambda a: cfg
        RD.input_specs = lambda c, s: {
            k: jax.ShapeDtypeStruct((int(sys.argv[2]),) + v.shape[1:],
                                    v.dtype)
            for k, v in configs.input_specs(c, s, True).items()}
        RD.SHAPES = {shape: (min(seq, 128), int(sys.argv[2]), kind)}
        rec = RD.dryrun_cell(arch, shape, len(mesh_shape) == 3,
                             tp=mesh_shape[-1])
        out[name] = {"flops": rec["hlo_flops"],
                     "bytes": rec["collective_bytes"]}
print(json.dumps(out))
"""

_PORT = r"""
import dataclasses, json, math, sys
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._pytree import tree_leaves
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, common

gathered = []                     # the shapes of every all-gather's result
count = D.OpCounter._count
def _count(self, func, args, kwargs, out, w):
    if func._opname.startswith("all_gather"):
        gathered.extend(list(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
    count(self, func, args, kwargs, out, w)
D.OpCounter._count = _count

def on_shards_partial_query(mesh):
    # q (B 8, 1, H 4, 16) pending over data, heads cut over model; a cache
    # of one KV head cut on its batch over data, whole over model
    q = DTensor.from_local(torch.empty(8, 1, 2, 16, device="meta"), mesh,
                           [Partial(), Shard(2)], run_check=False,
                           shape=torch.Size((8, 1, 4, 16)),
                           stride=(64, 64, 16, 1))
    kv = [DTensor.from_local(torch.empty(4, 64, 1, 16, device="meta"), mesh,
                             [Shard(0), Replicate()], run_check=False,
                             shape=torch.Size((8, 64, 1, 16)),
                             stride=(1024, 16, 16, 1)) for _ in range(2)]
    del gathered[:]
    with D.counting() as c:
        out = attention._sdpa(q, *kv, None, 0.25)
    return {"counts": {k[1]: v for k, v in c.counts.items()
                       if isinstance(k, tuple) and k[0] == "count"},
            "bytes": {k[1]: v for k, v in c.counts.items()
                      if isinstance(k, tuple) and k[0] == "bytes"},
            "gathered": list(gathered),
            "placements": [repr(p) for p in out.placements],
            "local": list(out.to_local().shape)}

def on_shards_cut_keys(mesh, grad):
    # q (B 2, S 8, H 4, 16) cut on its rows over data, heads over model;
    # keys and values of one head cut on their keys over data
    def dt(local, pl, shape):
        t = torch.empty(local, device="meta", requires_grad=grad)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    q = dt((2, 4, 2, 16), [Shard(1), Shard(2)], (2, 8, 4, 16))
    kv = [dt((2, 4, 1, 16), [Shard(1), Replicate()], (2, 8, 1, 16))
          for _ in range(2)]
    with torch.set_grad_enabled(grad), D.counting() as c:
        out = attention._sdpa(q, *kv, None, 0.25)
    return {"counts": {k[1]: v for k, v in c.counts.items()
                       if isinstance(k, tuple) and k[0] == "count"},
            "placements": [repr(p) for p in out.placements]}

out = {}
batch = int(sys.argv[2])
cells = sorted(json.loads(sys.argv[1]).items(),
               key=lambda kv: math.prod(kv[1][2]))
for name, (arch, shape, mesh_shape, over) in cells:
    # the smaller groups first (a group replaced mid-run leaves DTensor's
    # caches holding the old one)
    D.start_fake_group(math.prod(mesh_shape))
    mesh = make_mesh(tuple(mesh_shape),
                     ("pod", "data", "model")[-len(mesh_shape):], "cpu")
    if "on_shards" not in out:
        out["on_shards"] = on_shards_partial_query(mesh)
        out["cut_keys"] = {str(g): on_shards_cut_keys(mesh, g)
                           for g in (False, True)}
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    seq, _, kind = SHAPES[shape]
    inputs = {k: torch.empty((batch,) + tuple(v.shape[1:]), dtype=v.dtype,
                             device="meta")
              for k, v in input_specs(cfg, shape, True).items()}
    del gathered[:]
    got = D.counts(cfg, kind, inputs, min(seq, 128), mesh, D.Options())[0]
    out[name] = {"flops": got["flops"],
                 "bytes": {k[1]: v for k, v in got.items()
                           if isinstance(k, tuple) and k[0] == "bytes"},
                 "gathered": list(gathered), "tokens": batch * min(seq, 128),
                 "d_model": cfg.d_model}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def lowered():
    """{"reference": ..., "port": ...}: each package's counts per cell."""
    cells = json.dumps({k: list(v) for k, v in CELLS.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, cells, str(BATCH)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("reference", _REF), ("port", _PORT))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_work_per_device_is_the_reference_s(lowered, cell):
    ref, port = lowered["reference"][cell], lowered["port"][cell]
    assert port["flops"] <= FLOPS_LIMIT * ref["flops"], \
        (port["flops"] / ref["flops"], port, ref)
    assert sum(port["bytes"].values()) <= sum(ref["bytes"].values()), \
        (port["bytes"], ref["bytes"])


def test_no_rank_gathers_every_token_for_its_experts(lowered):
    """The MoE dispatch hands each rank its own slots' tokens: no
    all-gather's result holds the layer's T x d tokens."""
    port = lowered["port"]["moe"]
    assert port["gathered"]
    assert [port["tokens"], port["d_model"]] not in port["gathered"]


def test_on_shards_reduces_a_pending_query_onto_the_cache_s_shards(lowered):
    got = lowered["port"]["on_shards"]
    assert "all-gather" not in got["counts"], got
    assert not got["gathered"], got
    # the query (8 x 1 x 2 x 16 float32 on each rank) reduce-scattered
    # onto the cache's batch: each rank keeps its 4 rows
    assert got["counts"] == {"reduce-scatter": 1}, got
    assert got["bytes"] == {"reduce-scatter": 4 * 1 * 2 * 16 * 4}, got
    assert got["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
    assert got["local"] == [4, 1, 2, 16]


def test_on_shards_reduces_over_cut_keys_only_without_a_gradient(lowered):
    got = lowered["port"]["cut_keys"]
    # no gradient: the keys stay cut, the queries' rows are gathered (one
    # all-gather: a decode step's one row), the softmax's max and sum are
    # all-reduced over the keys' shards, the result a pending sum there
    assert got["False"]["placements"] == ["Partial(sum)", "Shard(dim=2)"], got
    assert got["False"]["counts"] == {"all-gather": 1, "all-reduce": 2}, got
    # a gradient: the keys and values gathered, the queries' rows kept cut
    assert got["True"]["placements"] == ["Shard(dim=1)", "Shard(dim=2)"], got
    assert got["True"]["counts"] == {"all-gather": 2}, got
