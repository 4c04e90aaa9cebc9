"""The port's sharding rules (repro_torch.distributed.shardings) against the
reference's (repro.distributed.shardings), spec for spec.

The reference's parameter and cache trees come from ``jax.eval_shape``
(no allocation), the port's from a model on the ``meta`` device, both at
the published widths.  The reference stacks each segment's layers on a
leading axis, which its specs give None; the port keeps one module per
layer, so each port spec must equal its reference leaf's with that leading
None dropped.  ``make_constrain``'s placements are read on a fake group of
4 ranks (no collective runs).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.distributed import shardings as ref_sh
from repro.models import Model as RefModel

from repro_torch import configs
from repro_torch.distributed import shardings as sh
from repro_torch.models import Model
from repro_torch.models.transformer import segments

FSDP = {"data": ("data",), "pod_data": ("pod", "data"), "serving": ()}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = RefModel(ref_get_config(arch), expert_pad=16, vocab_pad=128)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             dtype=jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return Model(configs.get_config(arch), device="meta", expert_pad=16,
                 vocab_pad=128)


def _ref_leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested tree; a spec is a leaf."""
    if isinstance(tree, (P, sh.Spec)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _ref_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _port_name_to_ref(cfg):
    """port layer index -> (segment, index within it)."""
    out, first = {}, 0
    for k, (_, count) in enumerate(segments(cfg)):
        for j in range(count):
            out[first + j] = k
        first += count
    return out


def _ref_spec_of(ref_specs, cfg, port_name):
    """The reference spec of a port parameter's leaf, its stacked axis's
    None dropped."""
    parts = port_name.split(".")
    if parts[0] == "layers":
        seg = _port_name_to_ref(cfg)[int(parts[1])]
        node = ref_specs["segments"][seg]
        for p in parts[2:]:
            node = node[p]
        assert node[0] is None, (port_name, node)
        return tuple(node)[1:]
    node = ref_specs
    for p in parts:
        node = node[p]
    return tuple(node)


@pytest.mark.parametrize("fsdp", list(FSDP), ids=list(FSDP))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, fsdp):
    cfg = configs.get_config(arch)
    axes = FSDP[fsdp]
    ref_specs = ref_sh.param_specs(_ref_params(arch),
                                   ref_sh.MeshAxes(fsdp=axes, tp="model"))
    model = _port_model(arch)
    specs = sh.param_specs(model, sh.MeshAxes(fsdp=axes, tp="model"))
    assert set(specs) == {n for n, _ in model.named_parameters()}
    n_ref = sum(1 for _ in _ref_leaves(_ref_params(arch)))
    n_stacked = sum(1 for path, _ in _ref_leaves(_ref_params(arch))
                    if path[0] == "segments")
    layers_per_leaf = {k: c for k, (_, c) in enumerate(segments(cfg))}
    # every reference leaf has its port parameters, and no more
    assert len(specs) == n_ref - n_stacked + sum(
        layers_per_leaf[path[1]] for path, _ in
        _ref_leaves(_ref_params(arch)) if path[0] == "segments")
    for name, spec in specs.items():
        assert isinstance(spec, sh.Spec)
        assert tuple(spec) == _ref_spec_of(ref_specs, cfg, name), name


def _cache_trees(arch, batch):
    ref_model = RefModel(ref_get_config(arch), expert_pad=16, vocab_pad=128)
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(
        batch, 1024, dtype=jnp.bfloat16))
    cache = _port_model(arch).init_cache(batch, 1024)
    return ref_cache, cache


@pytest.mark.parametrize("tp", [4, 16])
@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, batch, tp):
    cfg = configs.get_config(arch)
    mesh_shape = {"data": 256 // tp, "model": tp}
    ref_cache, cache = _cache_trees(arch, batch)
    ref_specs = ref_sh.cache_specs(ref_get_config(arch), ref_cache,
                                   ref_sh.MeshAxes(), batch, mesh_shape)
    specs = sh.cache_specs(cfg, cache, sh.MeshAxes(), batch, mesh_shape)
    seg_of = _port_name_to_ref(cfg)
    assert len(specs["layers"]) == cfg.n_layers
    for i, layer in enumerate(specs["layers"]):
        got = list(_ref_leaves(layer))
        want = list(_ref_leaves(ref_specs["segments"][seg_of[i]]))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, spec), (_, ref_spec) in zip(got, want):
            assert isinstance(spec, sh.Spec)
            assert ref_spec[0] is None
            assert tuple(spec) == tuple(ref_spec)[1:], (i, path)
    assert len(specs["shared"]) == len(ref_specs["shared"])
    for got, want in zip(specs["shared"], ref_specs["shared"]):
        assert [tuple(s) for _, s in _ref_leaves(got)] == \
            [tuple(s) for _, s in _ref_leaves(want)]


def test_batch_specs_equal_the_reference():
    like = {"tokens": torch.empty((8, 16), device="meta"),
            "patches": torch.empty((8, 4, 32), device="meta")}
    ref_like = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                for k, v in like.items()}
    for axes in (("data",), ("pod", "data")):
        want = ref_sh.batch_specs(ref_sh.MeshAxes(fsdp=axes), ref_like)
        got = sh.batch_specs(sh.MeshAxes(fsdp=axes), like)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


# the reference's five cases (tests/test_shardings.py), on the port's names

def _qwen_specs(fsdp):
    return sh.param_specs(_port_model("qwen1_5_110b"),
                          sh.MeshAxes(fsdp=fsdp, tp="model"))


def _case_2d():
    specs = _qwen_specs(("data",))
    assert specs["embed"] == P("model", "data")
    assert specs["lm_head"] == P("data", "model")
    assert specs["layers.0.attn.wq"] == P("data", "model")
    assert specs["layers.0.attn.wo"] == P("model", "data")
    assert specs["layers.0.ln1"] == P(None)          # norms replicate
    for name, p in _port_model("qwen1_5_110b").named_parameters():
        assert len(specs[name]) <= p.ndim


def _case_serving():
    specs = _qwen_specs(())
    assert specs["embed"] == P("model", None)
    assert specs["layers.0.attn.wq"] == P(None, "model")


def _case_multipod():
    assert _qwen_specs(("pod", "data"))["embed"] == \
        P("model", ("pod", "data"))


def _case_moe():
    specs = sh.param_specs(_port_model("deepseek_v2_236b"), sh.MeshAxes())
    assert specs["layers.1.moe.w_gate"] == P("model", "data", None)  # EP
    assert specs["layers.1.moe.w_down"] == P("model", None, "data")


def _case_cache():
    cfg = configs.get_config("qwen1_5_110b")
    model = _port_model("qwen1_5_110b")
    axes = sh.MeshAxes()
    c = model.init_cache(128, 1024)
    mesh_shape = {"data": 16, "model": 16}
    # batch 128 over 16 -> batch-sharded; kv=8 not divisible by 16 ->
    # heads replicated
    specs = sh.cache_specs(cfg, c, axes, 128, mesh_shape)
    assert specs["layers"][0]["k"] == P("data", None, None, None)
    # batch 1 -> sequence-sharded flash-decode
    c1 = model.init_cache(1, 1024)
    specs1 = sh.cache_specs(cfg, c1, axes, 1, mesh_shape)
    assert specs1["layers"][0]["k"] == P(None, "data", None, None)
    # tp=4 divides kv=8 -> heads shard too
    specs4 = sh.cache_specs(cfg, c, axes, 128, {"data": 64, "model": 4})
    assert specs4["layers"][0]["k"] == P("data", None, "model", None)


@pytest.mark.parametrize("case", [_case_2d, _case_serving, _case_multipod,
                                  _case_moe, _case_cache],
                         ids=["2d", "serving_tp_only", "multipod_fsdp",
                              "moe_experts", "cache_batch_vs_seq"])
def test_reference_cases(case):
    case()


# -- placements and the activation hook on a fake group ---------------------

@pytest.fixture(scope="module")
def fake_group():
    from repro_torch.launch.dryrun import start_fake_group
    assert not dist.is_initialized()
    start_fake_group(8)
    yield
    dist.destroy_process_group()


def _mesh(shape, names):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, names, "cpu")


def test_placements_follow_the_spec(fake_group):
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert sh.placements(mesh, sh.Spec(("pod", "data"), "model")) == \
        [Shard(0), Shard(0), Shard(1)]
    assert sh.placements(mesh, sh.Spec(None, None)) == [Replicate()] * 3
    view = sh.compute_mesh(mesh)
    assert view.mesh_dim_names == ("pod_data", "model")
    assert tuple(view.shape) == (4, 2)
    assert sh.compute_mesh(mesh) is view
    assert sh.placements(view, sh.Spec("model", ("pod", "data"))) == \
        [Shard(1), Shard(0)]


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_constrain_places_each_kind(fake_group, multi_pod, seq_parallel):
    if multi_pod:
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
        axes = sh.MeshAxes(fsdp=("pod", "data"))
    else:
        mesh = _mesh((4, 2), ("data", "model"))
        axes = sh.MeshAxes()
    constrain = sh.make_constrain(mesh, axes, seq_parallel)
    x = sh.shard_like(torch.empty((8, 16, 32), device="meta"), mesh,
                      sh.Spec(None, None, None))
    dp = [Shard(0)]
    got = {kind: list(constrain(x, kind).placements)
           for kind in ("logits", "residual", "activation")}
    assert got["logits"] == dp + [Shard(2)]
    assert got["activation"] == dp + [Replicate()]
    assert got["residual"] == dp + [Shard(1) if seq_parallel
                                    else Replicate()]
    plain = torch.empty((8, 16), device="meta")
    assert constrain(plain, "logits") is plain        # a plain tensor passes
    flat = sh.shard_like(torch.empty((8,), device="meta"), mesh,
                         sh.Spec(None))
    assert constrain(flat, "logits") is flat          # as does a 1-D one
