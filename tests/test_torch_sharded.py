"""The port's sharded path (distributed/shardings.py, launch/mesh.py,
Model.constrain, the train step and checkpoint under a mesh, launch/train.py
with --tp / --multi-pod / --seq-parallel) on 4 CPU ranks of one gloo
group, held against the reference (``repro.models``, its jitted train step)
and against the unsharded port.

One group is spawned for the whole module (initialised through a file in
the test's temporary directory, so test workers never share a port); rank
0 records every number and the tests read them.  Models are the reduced
configs of five families in float32 with the reference's noised init,
carried across by ``models/convert.py`` to every rank and to the unsharded
port; the experts are padded to the mesh's ``model`` size on all three
sides.  While the ranks run, this process computes the reference's logits
and one jitted train step on the same weights and batch, and, for the
trainer, the reference's steps from the trainer's own seed-0 weights
carried the other way.  The reference's numbers do not depend on its mesh
(a sharding changes where it computes, not what), so it runs unsharded.
The same group also runs ``tools/check_sharded_cpu.py``'s cases, on
meshes (1, 4) and (2, 2), with the reference's noised weights for their
configs, against the unsharded port and against the reference's forward,
train step, prefill and decode steps on the same weights and tokens.

Tolerances, the same against both: logits within relative L2 1e-5
(readings 6.1e-7 to 1.7e-6 against the unsharded port, 6.4e-7 to 1.9e-6
against the reference: the sharded products sum in another order); a
train step's loss within relative 1e-6 (readings up to 1.5e-7) and its
gradients' global norm within 1e-4 (up to 2.0e-6; ``test_torch_train.py``
holds each gradient leaf to 1e-4); the parameters after the step within
relative L2 1e-5 over the whole tree (up to 1.3e-6).  The check cases read,
against the reference, logits 6.7e-7 to 1.8e-6 (every prefill and decode
step), loss up to 7.1e-8, norm up to 2.5e-7, tree up to 1.2e-6; against the
unsharded port their own tool's limit, 1e-5 on each reading, holds them
(up to 1.3e-6).  Leaf by leaf the step is not held so tight: AdamW's first
step moves a parameter by about lr * sign(g), and where a gradient element
is a near-cancelling sum the summation order of the shards flips or scales
it, so a zero-initialised leaf (``mu_k``, ``conv_b``) can move apart by a
large share of its own norm while the whole tree stays close.
"""
from __future__ import annotations

import datetime
import functools
import importlib.util
import os
import pickle
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.models import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train import trainstep as ref_trainstep

from repro_torch import configs
from repro_torch.models import Model, convert
from repro_torch.models.transformer import segments

from test_torch_model_families import _noisy_params

ARCHS = ["mistral_nemo_12b", "deepseek_v2_236b", "granite_moe_3b_a800m",
         "zamba2_1_2b", "rwkv6_3b"]
# the MoE with GQA and the hybrid (Mamba2 and a shared attention block)
SEQ_PARALLEL_ARCHS = ["granite_moe_3b_a800m", "zamba2_1_2b"]
MULTI_POD_ARCHS = ["granite_moe_3b_a800m"]
WORLD = 4
TP = 2                      # the model axis of both meshes
SEED = 3
B, S = 4, 8
FWD_REL_L2 = 1e-5
LOSS_RTOL = 1e-6
NORM_RTOL = 1e-4
PARAM_REL_L2 = 1e-5
TRAIN_STEPS = 3
STEP_ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the cases a one-card mesh cannot reach (heads that the model axis does
# not divide, caches cut on their sequence, the experts' stacks kept in
# place or gathered), each against the unsharded model: the cases and
# checks of tools/check_sharded_cpu.py, run here on the same group
CHECK_TOOL = Path(__file__).resolve().parents[1] / "tools" / \
    "check_sharded_cpu.py"


def _check_tool():
    spec = importlib.util.spec_from_file_location("check_sharded_cpu",
                                                  CHECK_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECKS = [name for name, *_ in _check_tool()._cases()]


def _check_weights(arch, over, tp) -> str:
    """The file of the reference's weights for a check case's config."""
    tag = "".join(f"_{k}{v}" for k, v in sorted(over.items()))
    return f"check_{arch}{tag}_tp{tp}.pt"
TRAIN_ARGS = ["--smoke", "--device", "cpu", "--batch", str(B), "--seq",
              str(S), "--ckpt-every", "100"]


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).norm() /
            want.double().norm().clamp_min(1e-30)).item()


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(5).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _models(arch, mesh, axes, tmp, seq_parallel=False):
    """(unsharded, sharded) reduced models with the reference's weights,
    experts padded to the mesh's model size on both."""
    from repro_torch.distributed import shardings as sh
    cfg = configs.get_config(arch).reduced()
    tp = mesh.shape[mesh.mesh_dim_names.index("model")]
    assert tp == TP
    state = torch.load(os.path.join(tmp, f"{arch}.pt"))
    kw = dict(device="cpu", dtype=torch.float32, expert_pad=tp)
    ref = Model(cfg, **kw)
    ref.load_state_dict(state)
    sharded = Model(cfg, constrain=sh.make_constrain(mesh, axes,
                                                     seq_parallel), **kw)
    sharded.load_state_dict(state)
    sh.distribute_model(sharded, mesh, axes)
    return cfg, ref, sharded


def _batch(cfg, mesh, axes):
    from repro_torch.distributed import shardings as sh
    tokens = torch.from_numpy(_tokens(cfg))
    plain = {"tokens": tokens, "labels": tokens}
    return plain, sh.distribute_tree(plain, sh.batch_specs(axes, plain),
                                     mesh)


def _forward(arch, mesh, axes, tmp, seq_parallel=False) -> dict:
    cfg, ref, sharded = _models(arch, mesh, axes, tmp, seq_parallel)
    plain, dist_batch = _batch(cfg, mesh, axes)
    with torch.no_grad():
        want = ref(plain["tokens"])
        got = sharded(dist_batch["tokens"])
    return {"rel_l2": _rel_l2(got.full_tensor(), want),
            "placements": [repr(p) for p in got.placements],
            "logits": got.full_tensor()}


def _train_step(arch, mesh, axes, tmp) -> dict:
    from repro_torch.train import optimizer, trainstep
    cfg, ref, sharded = _models(arch, mesh, axes, tmp)
    plain, dist_batch = _batch(cfg, mesh, axes)
    ocfg = optimizer.AdamWConfig(**STEP_ADAMW)
    want = trainstep.make_train_step(ref, ocfg)(
        trainstep.init_train_state(ref), plain)
    state = trainstep.init_train_state(sharded)
    got = trainstep.make_train_step(sharded, ocfg)(state, dist_batch)
    params = {name: p.full_tensor() for name, p in
              sharded.named_parameters()}
    placed = all(tuple(state["opt"]["m"][name].placements) ==
                 tuple(p.placements)
                 for name, p in sharded.named_parameters())
    return {"loss": (got["loss"].item(), want["loss"].item()),
            "grad_norm": (got["grad_norm"].item(), want["grad_norm"].item()),
            "params_rel_l2": _tree_rel_l2(params,
                                          dict(ref.named_parameters())),
            "params": params,
            "state_placed_as_params": placed,
            "metrics_plain": all(type(v) is torch.Tensor
                                 for v in got.values())}


def _tree_rel_l2(got: dict, want: dict) -> float:
    diff = total = 0.0
    for name, w in want.items():
        w = torch.as_tensor(w).double()
        diff += (torch.as_tensor(got[name]).double() - w).square().sum().item()
        total += w.square().sum().item()
    return (diff / total) ** 0.5


def _checkpoint(tmp: str) -> dict:
    """A Granite model and its AdamW state on mesh (2, 2), saved, then
    restored onto (4, 1): every leaf equal, placed as the new mesh's."""
    from repro_torch.distributed import shardings as sh
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.train import trainstep
    axes = sh.MeshAxes()
    mesh_a = world_mesh(WORLD, 2, False, "cpu")
    _, _, model_a = _models("granite_moe_3b_a800m", mesh_a, axes, tmp)
    state_a = trainstep.init_train_state(model_a)
    for m in state_a["opt"]["m"].values():          # something to restore
        m.add_(torch.ones_like(m))
    tree_a = {"params": dict(model_a.named_parameters()), "state": state_a}
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), async_save=True)
    mgr.save(3, tree_a)
    mesh_b = world_mesh(WORLD, 1, False, "cpu")
    cfg = configs.get_config("granite_moe_3b_a800m").reduced()
    model_b = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=2,
                    generator=torch.Generator().manual_seed(99))
    sh.distribute_model(model_b, mesh_b, axes)
    like = {"params": dict(model_b.named_parameters()),
            "state": trainstep.init_train_state(model_b)}
    step, got, _ = mgr.restore_latest(like, device="cpu")
    from repro_torch.distributed.checkpoint import _flatten
    equal = placed = True
    for (_, a), (_, b), (_, t) in zip(_flatten(tree_a), _flatten(got),
                                      _flatten(like)):
        if hasattr(a, "full_tensor"):
            equal &= torch.equal(a.full_tensor(), b.full_tensor())
            placed &= (b.device_mesh is t.device_mesh and
                       tuple(b.placements) == tuple(t.placements))
        else:
            equal &= torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return {"step": step, "equal": bool(equal), "placed": bool(placed),
            "mesh_b": tuple(mesh_b.shape)}


def _worker(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    from repro_torch.distributed import shardings as sh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import world_mesh
    out: dict = {}

    def record(key, fn, *args):
        try:
            out[key] = fn(*args)
        except Exception:                  # every rank fails alike
            out[key] = {"error": traceback.format_exc()[-3000:]}

    try:
        mesh = world_mesh(world, 2, False, "cpu")
        axes = sh.MeshAxes()
        for arch in ARCHS:
            record(("forward", arch), _forward, arch, mesh, axes, tmp)
            record(("train", arch), _train_step, arch, mesh, axes, tmp)
        for arch in SEQ_PARALLEL_ARCHS:
            record(("seq_parallel", arch), _forward, arch, mesh, axes, tmp,
                   True)
        check = _check_tool()
        meshes = {(2, TP): mesh}
        for name, shape, fn, args in check._cases():
            if shape not in meshes:
                meshes[shape] = world_mesh(world, shape[1], False, "cpu")
            state = torch.load(os.path.join(tmp, _check_weights(
                args[0], args[1], shape[1])))
            record(("check", name), functools.partial(fn, state=state),
                   args[0], meshes[shape], *args[1:])
        pod = world_mesh(world, 2, True, "cpu")
        pod_axes = sh.MeshAxes(fsdp=("pod", "data"))
        for arch in MULTI_POD_ARCHS:
            record(("multi_pod_forward", arch), _forward, arch, pod,
                   pod_axes, tmp)
            record(("multi_pod_train", arch), _train_step, arch, pod,
                   pod_axes, tmp)

        def trainer(args):
            res = train.main(TRAIN_ARGS + args)
            return {k: res[k] for k in ("arch", "start", "steps", "loss",
                                        "grad_norm")} | {
                "mesh": dict(zip(res["mesh"].mesh_dim_names,
                                 res["mesh"].shape))}

        record("trainer_tp2", trainer,
               ["--tp", "2", "--steps", str(TRAIN_STEPS), "--ckpt-dir",
                os.path.join(tmp, "trainer_tp2")])
        record("trainer_multi_pod", trainer,
               ["--tp", "2", "--multi-pod", "--seq-parallel", "--steps", "1",
                "--ckpt-dir", os.path.join(tmp, "trainer_pod")])
        record("checkpoint", _checkpoint, tmp)
    finally:
        if rank == 0:
            with open(os.path.join(tmp, "results.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


def _to_ref_tree(cfg, like: dict, state: dict) -> dict:
    """The inverse of ``convert.from_jax_params``: a port state dict as the
    reference's tree, whose structure ``like`` gives (each segment's layers
    stacked on a leading axis)."""
    sd = {k: v.detach().numpy() for k, v in state.items()}

    def fill(node, get, prefix=""):
        return {k: fill(v, get, f"{prefix}{k}.") if isinstance(v, dict)
                else get(prefix + k) for k, v in node.items()}

    tree = {k: sd[k] for k in ("embed", "final_norm", "lm_head") if k in like}
    tree["segments"], first = [], 0
    for (_, count), seg in zip(segments(cfg), like["segments"]):
        tree["segments"].append(fill(seg, lambda p, f=first, c=count: np.stack(
            [sd[f"layers.{f + i}.{p}"] for i in range(c)])))
        first += count
    if "shared" in like:
        tree["shared"] = fill(like["shared"], lambda p: sd[f"shared.{p}"])
    return tree


def _reference(trees: dict) -> dict:
    """The reference's numbers on the weights written for the ranks: the
    logits, one train step, and the trainer's losses from the port's seed-0
    weights."""
    out = {}
    for arch in ARCHS:
        cfg = configs.get_config(arch).reduced()
        ref = RefModel(cfg, expert_pad=TP)
        params = jax.tree.map(jnp.asarray, trees[arch])
        tokens = jnp.asarray(_tokens(cfg))
        out[("forward", arch)] = np.asarray(ref._forward_aux(params,
                                                             tokens)[0])
        step = jax.jit(ref_trainstep.make_train_step(
            ref, ref_opt.AdamWConfig(**STEP_ADAMW)))
        new, _, metrics = step(params, ref_trainstep.init_train_state(
            ref, params), {"tokens": tokens, "labels": tokens})
        out[("train", arch)] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": convert.from_jax_params(
                cfg, jax.tree.map(np.asarray, new))}
    for steps in (TRAIN_STEPS, 1):
        out[("trainer", steps)] = _reference_trainer(steps)
    return out


def _reference_checks(trees: dict) -> dict:
    """The reference's outputs for ``tools/check_sharded_cpu.py``'s cases on
    the weights written for the ranks, keyed as the ranks record them: the
    logits of a forward, the prefill's and each decode step's, or a train
    step's loss, norm and parameters."""
    check = _check_tool()
    out = {}
    for name, shape, fn, args in check._cases():
        arch, over, *rest = args
        cfg = check.config(arch, over)
        ref = RefModel(cfg, expert_pad=shape[1])
        params = jax.tree.map(jnp.asarray, trees[_check_weights(
            arch, over, shape[1])])

        def toks(batch, seq):
            return jnp.asarray(check.tokens_of(cfg, batch, seq).numpy()
                               .astype(np.int32))
        if fn is check.forward:
            seq = rest[0] if rest else check.S
            want = {"logits": np.asarray(ref._forward_aux(
                params, toks(check.B, seq))[0])}
        elif fn is check.train_step:
            tokens = toks(check.B, check.S)
            step = jax.jit(ref_trainstep.make_train_step(
                ref, ref_opt.AdamWConfig(**check.ADAMW)))
            new, _, metrics = step(params, ref_trainstep.init_train_state(
                ref, params), {"tokens": tokens, "labels": tokens})
            want = {"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "params": convert.from_jax_params(
                        cfg, jax.tree.map(np.asarray, new))}
        else:
            batch, = rest
            n = check.PROMPT + check.STEPS
            tokens = toks(batch, n)
            logits, cache = ref.prefill(
                params, tokens[:, :check.PROMPT],
                ref.init_cache(batch, n, dtype=jnp.float32))
            want = {"logits": [np.asarray(logits)]}
            for pos in range(check.PROMPT, n):
                logits, cache = ref.decode(params, tokens[:, pos:pos + 1],
                                           cache, pos)
                want["logits"].append(np.asarray(logits))
        out[name] = want
    return out


def _reference_trainer(steps: int) -> list[float]:
    """The reference's losses for ``launch/train.py --smoke`` on the (2, 2)
    mesh: its seed-0 weights (experts padded to 2), its batches and AdamW
    settings, through the reference's jitted step."""
    cfg = configs.get_config("granite_moe_3b_a800m").reduced()
    port = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=TP,
                 generator=torch.Generator().manual_seed(0))
    ref = RefModel(cfg, expert_pad=TP)
    like = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0),
                                           dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray,
                          _to_ref_tree(cfg, like, port.state_dict()))
    assert jax.tree.map(lambda a: a.shape, params) == \
        jax.tree.map(lambda a: a.shape, like)
    step = jax.jit(ref_trainstep.make_train_step(ref, ref_opt.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps)))
    state = ref_trainstep.init_train_state(ref, params)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        tokens = jnp.asarray(rng.integers(0, cfg.vocab, (B, S))
                             .astype(np.int32))
        params, state, metrics = step(params, state, {"tokens": tokens,
                                                      "labels": tokens})
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' records, and the reference's under ``"reference"``."""
    tmp = tmp_path_factory.mktemp("sharded")
    trees = {}
    for arch in ARCHS:
        cfg = configs.get_config(arch).reduced()
        trees[arch] = _noisy_params(RefModel(cfg, expert_pad=TP), SEED)
        torch.save(convert.from_jax_params(cfg, trees[arch]),
                   tmp / f"{arch}.pt")
    check = _check_tool()
    for _, shape, _, (arch, over, *_) in check._cases():
        name = _check_weights(arch, over, shape[1])
        if name not in trees:
            cfg = check.config(arch, over)
            trees[name] = _noisy_params(RefModel(cfg, expert_pad=shape[1]),
                                        SEED)
            torch.save(convert.from_jax_params(cfg, trees[name]), tmp / name)
    ctx = mp.spawn(_worker, args=(WORLD, str(tmp)), nprocs=WORLD,
                   join=False)
    try:
        reference = _reference(trees)
        reference["check"] = _reference_checks(trees)
    finally:
        while not ctx.join():
            pass
    with open(tmp / "results.pkl", "rb") as f:
        out = pickle.load(f)
    out["reference"] = reference
    return out


def _get(runs, key) -> dict:
    res = runs[key]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_unsharded(runs, arch):
    res = _get(runs, ("forward", arch))
    assert res["rel_l2"] <= FWD_REL_L2, res["rel_l2"]
    # the logits come out as the reference's constrain places them
    assert res["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]


def _check_step(res):
    (loss, want_loss), (norm, want_norm) = res["loss"], res["grad_norm"]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), res
    assert abs(norm - want_norm) <= NORM_RTOL * want_norm, res
    assert res["params_rel_l2"] <= PARAM_REL_L2, res
    assert res["state_placed_as_params"] and res["metrics_plain"], res


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(runs, arch):
    _check_step(_get(runs, ("train", arch)))


@pytest.mark.parametrize("arch", SEQ_PARALLEL_ARCHS)
def test_seq_parallel_equals_off(runs, arch):
    on = _get(runs, ("seq_parallel", arch))
    off = _get(runs, ("forward", arch))
    assert on["rel_l2"] <= FWD_REL_L2
    assert _rel_l2(on["logits"], off["logits"]) <= FWD_REL_L2


@pytest.mark.parametrize("name", CHECKS)
def test_sharded_path_matches_unsharded_where_the_mesh_cuts_more(runs,
                                                                  name):
    """``tools/check_sharded_cpu.py``'s cases on this group: uneven heads
    on (1, 4) (forward, a train step, decodes of batch 3 and 1: ROADMAP
    C11), decodes on (2, 2) with caches cut on their sequence or batch,
    the experts' stacks gathered; each reading (relative L2 of the logits;
    of the loss, the gradients' norm and the parameters after a step) at
    most the tool's tolerance."""
    res = _get(runs, ("check", name))["readings"]
    assert max(res.values()) <= _check_tool().TOL, res


@pytest.mark.parametrize("arch", MULTI_POD_ARCHS)
def test_multi_pod_mesh_matches_unsharded(runs, arch):
    res = _get(runs, ("multi_pod_forward", arch))
    assert res["rel_l2"] <= FWD_REL_L2, res["rel_l2"]
    _check_step(_get(runs, ("multi_pod_train", arch)))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHECKS)
def test_sharded_path_matches_reference_where_the_mesh_cuts_more(runs, name):
    """The same cases held against the reference on the same weights and
    tokens: each logits tensor (a forward's; the prefill's and each decode
    step's) within ``FWD_REL_L2``, a train step's loss, norm and parameters
    within the limits of the steps above."""
    got = _get(runs, ("check", name))["outputs"]
    want = runs["reference"]["check"][name]
    if "params" in want:
        assert abs(got["loss"] - want["loss"]) <= \
            LOSS_RTOL * abs(want["loss"]), (got["loss"], want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            NORM_RTOL * want["grad_norm"], (got["grad_norm"],
                                            want["grad_norm"])
        rel = _tree_rel_l2(got["params"], want["params"])
        assert rel <= PARAM_REL_L2, rel
        return
    logits = got["logits"] if isinstance(got["logits"], list) \
        else [got["logits"]]
    wants = want["logits"] if isinstance(want["logits"], list) \
        else [want["logits"]]
    assert len(logits) == len(wants)
    for g, w in zip(logits, wants):
        w = torch.tensor(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        rel = _rel_l2(g, w)
        assert rel <= FWD_REL_L2, rel


def _ref_logits(runs, arch) -> torch.Tensor:
    return torch.tensor(runs["reference"][("forward", arch)])


def _check_step_against_reference(res, want):
    loss, norm = res["loss"][0], res["grad_norm"][0]
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), \
        (loss, want["loss"])
    assert abs(norm - want["grad_norm"]) <= NORM_RTOL * want["grad_norm"], \
        (norm, want["grad_norm"])
    rel = _tree_rel_l2(res["params"], want["params"])
    assert rel <= PARAM_REL_L2, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_reference(runs, arch):
    got = _get(runs, ("forward", arch))["logits"]
    want = _ref_logits(runs, arch)
    assert got.shape == want.shape
    rel = _rel_l2(got, want)
    assert rel <= FWD_REL_L2, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(runs, arch):
    _check_step_against_reference(_get(runs, ("train", arch)),
                                  runs["reference"][("train", arch)])


@pytest.mark.parametrize("arch", SEQ_PARALLEL_ARCHS)
def test_seq_parallel_matches_reference(runs, arch):
    got = _get(runs, ("seq_parallel", arch))["logits"]
    want = _ref_logits(runs, arch)
    rel = _rel_l2(got, want)
    assert rel <= FWD_REL_L2, rel


@pytest.mark.parametrize("arch", MULTI_POD_ARCHS)
def test_multi_pod_mesh_matches_reference(runs, arch):
    got = _get(runs, ("multi_pod_forward", arch))["logits"]
    want = _ref_logits(runs, arch)
    rel = _rel_l2(got, want)
    assert rel <= FWD_REL_L2, rel
    _check_step_against_reference(_get(runs, ("multi_pod_train", arch)),
                                  runs["reference"][("train", arch)])


@pytest.mark.parametrize("key,steps", [("trainer_tp2", TRAIN_STEPS),
                                       ("trainer_multi_pod", 1)])
def test_trainer_matches_reference(runs, key, steps):
    """``launch/train.py --smoke --tp 2`` (and ``--multi-pod
    --seq-parallel``) on 4 ranks against the reference's jitted steps from
    the same seed-0 weights and batches."""
    got = _get(runs, key)["loss"]
    want = runs["reference"][("trainer", steps)]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _one_rank_losses(steps: int) -> list[float]:
    """The trainer's loop on one unsharded model with the experts padded as
    the (2, 2) mesh pads them: the same seed, batches and AdamW settings."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import optimizer, trainstep
    cfg = get_config("granite_moe_3b_a800m").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=2,
                  generator=torch.Generator().manual_seed(0))
    step = trainstep.make_train_step(model, optimizer.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps))
    state = trainstep.init_train_state(model)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                  .astype(np.int32))
        losses.append(step(state, {"tokens": tokens,
                                   "labels": tokens})["loss"].item())
    return losses


def test_trainer_tp2_matches_one_rank(runs):
    res = _get(runs, "trainer_tp2")
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["steps"] == list(range(1, TRAIN_STEPS + 1))
    want = _one_rank_losses(TRAIN_STEPS)
    np.testing.assert_allclose(res["loss"], want, rtol=LOSS_RTOL)


def test_trainer_multi_pod_seq_parallel_runs(runs):
    res = _get(runs, "trainer_multi_pod")
    assert res["mesh"] == {"pod": 2, "data": 1, "model": 2}
    np.testing.assert_allclose(res["loss"], _one_rank_losses(1),
                               rtol=LOSS_RTOL)


def test_checkpoint_restores_onto_another_mesh(runs):
    res = _get(runs, "checkpoint")
    assert res == {"step": 3, "equal": True, "placed": True,
                   "mesh_b": (4, 1)}
