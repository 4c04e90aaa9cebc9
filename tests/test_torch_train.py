"""The port's training path (repro_torch.train, Model.loss and remat,
launch/train.py) against the reference's (repro.train, repro.models), on
the CPU at the configs' reduced sizes in float32.

Weights come from the reference's ``Model.init`` with every constant leaf
set to noise (as ``test_torch_model_families.py`` does) and are carried
across with ``convert.from_jax_params``; gradients come back leaf by leaf
through the same converter.  Tolerances: the loss and its parts at relative
1e-5, every gradient leaf at relative L2 1e-4 (a few layers at d 128 in
float32, summed in another order by each framework); the optimizer's
arithmetic at relative 1e-6 (float32) and one ulp (bf16 leaves); three
train steps at relative 1e-5 (losses) and relative L2 1e-4 (parameters).
An MoE layer's routing (``top_e``) must equal the reference's before any
number is compared, so that a near-tie shows as a tie.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import Model as RefModel
from repro.models import common as ref_common
from repro.train import optimizer as ref_opt
from repro.train import trainstep as ref_trainstep

from repro_torch import configs
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as train_cli
from repro_torch.models import Model, convert, moe
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.transformer import segments
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep

from test_torch_model_families import _Routes, _noisy_params

B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _rel_l2(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.fixture(autouse=True)
def one_thread():
    """The port on one CPU thread: a reduced model's operations gain
    nothing from more, and on a host shared with other test workers a pool
    of threads a worker makes them several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, seed):
    """The reference's noised float32 init, as numpy (read only)."""
    cfg = configs.get_config(arch).reduced()
    return _noisy_params(RefModel(cfg, expert_pad=1), seed)


def _build(arch, seed=0, batch=B):
    cfg = configs.get_config(arch).reduced()
    ref = RefModel(cfg, expert_pad=1)
    tree = _ref_tree(arch, seed)
    port = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=1)
    port.load_state_dict(convert.from_jax_params(cfg, tree))
    rng = np.random.default_rng(seed + 1)
    batch_np = {"tokens": rng.integers(0, cfg.vocab, (batch, S))
                .astype(np.int32)}
    batch_np["labels"] = batch_np["tokens"]
    if cfg.frontend == "vision_patches":
        batch_np["patches"] = rng.normal(
            size=(batch, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, batch_np


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _extra(batch):
    return {k: v for k, v in batch.items()
            if k not in ("tokens", "labels")} or None


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_reference(dtype):
    """Value and gradient (with respect to the logits) at relative 1e-6,
    on logits far from zero, in float32 and bf16."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4 + 30).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jdt = getattr(jnp, dtype)
    want, want_g = jax.value_and_grad(
        lambda x: ref_common.softmax_cross_entropy(x, jnp.asarray(labels)))(
        jnp.asarray(logits).astype(jdt))
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got = softmax_cross_entropy(x, torch.from_numpy(labels))
    (got_g,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float32 and got_g.dtype == x.dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-9 if dtype == "float32"
                               else 0)


_LOSS_CACHE = {}


def _loss_and_grads(arch, monkeypatch):
    """The reference's (loss, aux, gradient tree as the port's state dict)
    and the port's (loss, aux, gradients by name), routing checked first."""
    if arch in _LOSS_CACHE:
        return _LOSS_CACHE[arch]
    cfg, ref, params, port, batch = _build(arch)
    routes = _Routes(monkeypatch)
    jb = _jx(batch)
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, jb["tokens"], jb["labels"], extra=_extra(jb)),
        has_aux=True))(params)
    jax.effects_barrier()
    port.requires_grad_(True)
    total, aux = port.loss(torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]),
                           _extra(_tx(batch)))
    routes.check(sum(c for kind, c in segments(cfg) if kind == "moe"))
    names, leaves = zip(*port.named_parameters())
    grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    want_g = convert.from_jax_params(cfg, jax.tree.map(np.asarray, want_g))
    out = ((float(want), {k: float(v) for k, v in want_aux.items()}, want_g),
           (float(total), {k: float(v) for k, v in aux.items()},
            dict(zip(names, grads))))
    _LOSS_CACHE[arch] = out
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_matches_reference(monkeypatch, arch):
    """``total``, ``ce``, ``lb_loss`` and ``drop_frac`` at relative 1e-5
    (paligemma with its patch prefix cut off the logits)."""
    (want, want_aux, _), (got, got_aux, _) = _loss_and_grads(arch,
                                                             monkeypatch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert sorted(got_aux) == sorted(want_aux) == ["ce", "drop_frac",
                                                   "lb_loss"]
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got, got_aux["ce"] + 0.01 * got_aux["lb_loss"],
                               rtol=1e-7)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_gradients_match_reference(monkeypatch, arch):
    """Every leaf's gradient against ``jax.value_and_grad`` of the
    reference's loss, mapped through ``from_jax_params``: relative L2
    1e-4."""
    (_, _, want_g), (_, _, got_g) = _loss_and_grads(arch, monkeypatch)
    assert sorted(got_g) == sorted(want_g)
    for name, g in got_g.items():
        assert g.shape == want_g[name].shape, name
        assert _rel_l2(g.numpy(), want_g[name].numpy()) <= GRAD_REL_L2, name
    assert any(float(g.abs().max()) > 0 for g in got_g.values())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_remat_is_byte_identical(monkeypatch, arch):
    """``remat="full"`` recomputes each layer in the backward pass: the loss
    and every gradient equal ``remat="none"``'s byte for byte on the CPU,
    and the counting rank runs twice a MoE layer against once."""
    from repro_torch.core import exchange
    cfg = configs.get_config(arch).reduced()
    ranks = []
    real = exchange._dispatch_offsets

    def counted(*args):
        ranks.append(1)
        return real(*args)

    monkeypatch.setattr(moe, "_dispatch_offsets", counted)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": torch.randn(
            (B, cfg.n_prefix, cfg.d_model),
            generator=torch.Generator().manual_seed(4))}
    out = {}
    for remat in ("none", "full"):
        model = Model(cfg, device="cpu", dtype=torch.float32, remat=remat,
                      generator=torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        ranks.clear()
        total, _ = model.loss(tokens, tokens, extra)
        grads = torch.autograd.grad(total, list(model.parameters()))
        out[remat] = (total, grads, len(ranks))
    (t0, g0, r0), (t1, g1, r1) = out["none"], out["full"]
    assert t0.item() == t1.item()
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    n_moe = sum(c for kind, c in segments(cfg) if kind == "moe")
    assert (r0, r1) == (n_moe, 2 * n_moe)


def test_remat_must_be_none_or_full():
    cfg = configs.get_config("mistral_nemo_12b").reduced()
    with pytest.raises(ValueError, match="remat"):
        Model(cfg, device="cpu", remat="dots")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 30), (0, 1), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    ref_cfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=warmup,
                                  total_steps=total)
    for step in range(total + 6):
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.float32(step)))
        got = opt.lr_schedule(cfg, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=str(step))
        assert float(opt.lr_schedule(cfg, torch.tensor(step))) == float(got)


_SHAPES = {"w": (16, 24), "e": (3, 8, 8), "b": (24,), "s": (5,)}


def _tree(rng, dtype, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in _SHAPES.items()}


def _close_to_leaf(got, want, msg):
    """Element by element within 1e-6 of the leaf's largest magnitude: the
    two sides' global norms differ in the last bit (another order of
    summation), and a moment that nearly cancels keeps that bit's absolute
    size, not its relative one."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_update_matches_reference(dtype):
    """Three rounds on a tree of 2-D, 3-D and 1-D leaves (the first and
    last rounds' gradients clipped, the second's not): ``grad_norm`` and
    ``lr`` at relative 1e-6, parameters, ``m`` and ``v`` within 1e-6 of
    each leaf's largest magnitude; bf16 parameters within one ulp of the
    reference's."""
    rng = np.random.default_rng(0)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    ref_cfg = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    init = _tree(rng, dtype)
    ref_p = {k: jnp.asarray(v).astype(jdt) for k, v in init.items()}
    ref_s = ref_opt.init_state(ref_p)
    params = {k: torch.from_numpy(v).to(tdt) for k, v in init.items()}
    state = opt.init_state(params)
    decay = {k for k, p in params.items() if p.ndim >= 2}
    assert state["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in state["m"].values())
    for rnd, scale in enumerate((10.0, 0.01, 0.1)):
        g = _tree(rng, dtype, scale)
        ref_p, ref_s, ref_m = ref_opt.apply_update(
            ref_cfg, ref_p, {k: jnp.asarray(v).astype(jdt)
                             for k, v in g.items()}, ref_s)
        got_m = opt.apply_update(cfg, params, {
            k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, state,
            decay)
        assert int(state["step"]) == int(ref_s["step"]) == rnd + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                       rtol=1e-6, err_msg=k)
        if rnd == 0:
            assert float(got_m["grad_norm"]) > cfg.grad_clip
        for k in _SHAPES:
            for part in ("m", "v"):
                _close_to_leaf(state[part][k].numpy(),
                               np.asarray(ref_s[part][k]), f"{part} {k} {rnd}")
            got = params[k].float().numpy()
            want = np.asarray(ref_p[k].astype(jnp.float32))
            assert params[k].dtype == tdt
            if dtype == "float32":
                _close_to_leaf(got, want, f"{k} {rnd}")
            else:   # within one bf16 ulp (8 bits of mantissa)
                ulp = np.exp2(np.floor(np.log2(np.maximum(
                    np.abs(want), 1e-30))) - 7)
                assert np.all(np.abs(got - want) <= ulp), (k, rnd)


def test_compress_bf16_is_exact():
    rng = np.random.default_rng(1)
    g = _tree(rng, "float32", 3.0)
    want = ref_opt.compress_bf16({k: jnp.asarray(v) for k, v in g.items()})
    got = opt.compress_bf16({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k].astype(jnp.float32)))


def test_compress_int8_ef_matches_reference():
    """Three rounds, each feeding its residual to the next: the quantized
    gradients and the residual equal the reference's, except where
    ``g / scale`` lies within 1e-6 of a rounding boundary."""
    rng = np.random.default_rng(2)
    params = {k: torch.zeros(s) for k, s in _SHAPES.items()}
    res = opt.init_error_feedback(params)
    ref_res = ref_opt.init_error_feedback({k: jnp.zeros(s)
                                           for k, s in _SHAPES.items()})
    ties = 0
    for rnd in range(3):
        g = _tree(rng, "float32", 0.5)
        g_in = {k: v + res[k].numpy() for k, v in g.items()}
        want, ref_res = ref_opt.compress_int8_ef(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_res)
        got, res = opt.compress_int8_ef(
            {k: torch.from_numpy(v) for k, v in g.items()}, res,
            [[k] for k in g])
        for k in g:
            scale = max(np.abs(g_in[k]).max(), 1e-9) / 127.0
            frac = np.abs(g_in[k] / scale) % 1.0
            away = np.abs(frac - 0.5) > 1e-6
            ties += int((~away).sum())
            for a, b in ((got[k], want[k]), (res[k], ref_res[k])):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy()[away],
                                              np.asarray(b)[away],
                                              err_msg=f"{k} {rnd}")
            assert np.abs(np.round(got[k].numpy() / scale)).max() <= 127
    assert ties <= 2


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_STEP_CASES = [(a, c, m) for a in ("granite_moe_3b_a800m", "mistral_nemo_12b")
               for c in trainstep.GRAD_COMPRESS for m in (1, 2)]


@pytest.mark.parametrize("arch,compress,micro", _STEP_CASES,
                         ids=[f"{a}-{c}-mb{m}" for a, c, m in _STEP_CASES])
def test_train_step_matches_reference(arch, compress, micro):
    """Three steps of ``make_train_step`` against the reference's jitted
    step on the same batches: the metrics at relative 1e-5, every
    parameter after the steps at relative L2 1e-4.  Under int8_ef the
    gradient norm is the quantized gradients': a gradient that differs
    from the reference's in its last bits may round to the next of 255
    levels where it lies near a boundary, so that norm is held to 1e-4."""
    cfg, ref, params, port, _ = _build(arch, seed=7)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    ref_step = jax.jit(ref_trainstep.make_train_step(
        ref, ref_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3),
        compress, micro))
    ref_state = ref_trainstep.init_train_state(ref, params, compress)
    step = trainstep.make_train_step(port, ocfg, compress, micro)
    state = trainstep.init_train_state(port, compress)
    rng = np.random.default_rng(8)
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
        params, ref_state, want = ref_step(
            params, ref_state, {"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(tokens)})
        t = torch.from_numpy(tokens)
        got = step(state, {"tokens": t, "labels": t})
        assert sorted(got) == sorted(want) == sorted(
            ["loss", "ce", "lb_loss", "drop_frac", "grad_norm", "lr"])
        for k in want:
            rtol = 1e-4 if (k, compress) == ("grad_norm", "int8_ef") \
                else LOSS_RTOL
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=rtol, atol=1e-7,
                                       err_msg=f"{k} step {i + 1}")
    want_p = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    for name, p in port.named_parameters():
        assert _rel_l2(p.detach().numpy(), want_p[name].numpy()) <= \
            GRAD_REL_L2, name
    assert int(state["opt"]["step"]) == 3
    if compress == "int8_ef":
        assert sorted(state["ef"]) == sorted(want_p)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_leaves_and_weight_decay_are_the_reference_layouts(arch):
    """``reference_leaves`` groups the parameters as the reference's leaves
    (one group a stacked leaf, numbered through ``from_jax_params``), and
    the decayed parameters are those of its leaves of two or more
    dimensions."""
    cfg = configs.get_config(arch).reduced()
    ref = RefModel(cfg, expert_pad=1)
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0),
                                             jnp.float32))
    leaves = jax.tree.leaves(shapes)
    ids = jax.tree.unflatten(jax.tree.structure(shapes), [
        np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)])
    leaf_of = {k: int(v.reshape(-1)[0])
               for k, v in convert.from_jax_params(cfg, ids).items()}
    model = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=1)
    groups = trainstep.reference_leaves(model)
    for g in groups:
        assert len({leaf_of[k] for k in g}) == 1, g
    assert sorted(leaf_of[g[0]] for g in groups) == list(range(len(leaves)))
    want = {k for k, i in leaf_of.items() if leaves[i].ndim >= 2}
    assert trainstep.weight_decayed(model) == want
    assert "final_norm" not in want
    assert any(k.startswith("layers.0.ln") for k in want)


def test_train_step_refuses_an_unknown_compression():
    cfg = configs.get_config("mistral_nemo_12b").reduced()
    with pytest.raises(ValueError, match="grad_compress"):
        trainstep.make_train_step(Model(cfg, device="cpu"),
                                  opt.AdamWConfig(), "fp8")


# ---------------------------------------------------------------------------
# no gradient where the reference has none; no graph where none is needed
# ---------------------------------------------------------------------------

def test_flash_attention_raises_under_grad():
    """The flash wrapper has no backward: asked for a gradient it raises (on
    the CPU as on the card), and a loss through ``use_flash_kernel=True``
    does too; without a gradient it runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 32), generator=g) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    cfg = configs.get_config("mistral_nemo_12b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32,
                  use_flash_kernel=True)
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    model.loss(tokens, tokens)          # no parameter asks for a gradient
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(tokens, tokens)


def test_served_forward_builds_no_graph():
    """Parameters are made without gradients; once a trainer turns them on,
    a forward under ``torch.inference_mode`` and the serving steps still
    build no graph."""
    cfg = configs.get_config("granite_moe_3b_a800m").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    assert model(tokens).grad_fn is None
    trainstep.make_train_step(model, opt.AdamWConfig())
    assert all(p.requires_grad for p in model.parameters())
    assert model(tokens).grad_fn is not None
    with torch.inference_mode():
        assert model(tokens).grad_fn is None
    logits, cache = trainstep.make_prefill_step(model, 2, 12,
                                                torch.float32)(
        {"tokens": tokens})
    assert logits.grad_fn is None and not logits.requires_grad
    logits, _ = trainstep.make_decode_step(model)(
        logits.argmax(-1), cache, 8)
    assert logits.grad_fn is None and logits.shape == (2, 1, cfg.vocab)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

_SMOKE = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16"]


def test_trainer_checkpoints_and_restores(tmp_path, capsys):
    """Two runs into one directory: the first saves step 3, the second
    restores it (parameters and optimizer state equal to the saved ones)
    and goes on from step 4."""
    args = _SMOKE + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = train_cli.main(args + ["--steps", "3"])
    assert first["start"] == 0 and first["steps"] == [1, 2, 3]
    assert all(np.isfinite(first["loss"] + first["grad_norm"]))
    saved = {k: p.detach().clone()
             for k, p in first["model"].named_parameters()}
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = train_cli.main(args + ["--steps", "0"])
    assert restored["start"] == 3 and restored["steps"] == []
    for k, p in restored["model"].named_parameters():
        assert torch.equal(p.detach(), saved[k]), k
        assert p.requires_grad
    assert int(restored["state"]["opt"]["step"]) == 3
    for part in ("m", "v"):
        for k, t in first["state"]["opt"][part].items():
            assert torch.equal(restored["state"]["opt"][part][k], t)
    second = train_cli.main(args + ["--steps", "2"])
    assert second["start"] == 3 and second["steps"] == [4, 5]
    assert int(second["state"]["opt"]["step"]) == 5
    out = capsys.readouterr().out
    assert "restored step 3" in out and "step    4 loss=" in out


def test_trainer_retries_only_before_the_update(tmp_path, monkeypatch,
                                                capsys):
    """A fault in the loss (before the update) is retried and the step
    completes; a fault in the in-place update re-raises at once."""
    args = _SMOKE + ["--ckpt-dir", str(tmp_path), "--steps", "2"]
    loss = Model.loss
    faults = iter([True])

    def flaky_loss(self, *a, **kw):
        if next(faults, False):
            raise RuntimeError("transient device fault")
        return loss(self, *a, **kw)

    monkeypatch.setattr(Model, "loss", flaky_loss)
    out = train_cli.main(args)
    assert out["steps"] == [1, 2]
    assert "step 1 attempt 1 failed: transient device fault" in \
        capsys.readouterr().out
    monkeypatch.setattr(Model, "loss", loss)
    calls = []

    def broken_update(*a, **kw):
        calls.append(1)
        raise RuntimeError("fault during the update")

    monkeypatch.setattr(opt, "apply_update", broken_update)
    with pytest.raises(trainstep.UpdateFailed, match="fault during"):
        train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(calls) == 1


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--multi-pod"],
                                  ["--seq-parallel", "--tp", "2"]])
def test_trainer_refuses_sharded_meshes(flag):
    """A mesh the launched world cannot hold (one process here: data x
    model 2, or two pods) is refused before any process group is made; the
    sharded trainer itself runs in ``test_torch_sharded.py``."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="does not split"):
        train_cli.main(_SMOKE + flag)
    assert not dist.is_initialized()


def test_trainer_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke"])
