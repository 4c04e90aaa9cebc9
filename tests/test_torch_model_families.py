"""The port's MoE, MLA, Mamba2-hybrid and RWKV6 language models
(repro_torch.models) against the reference's (repro.models), on the CPU at
the configs' reduced sizes in float32.

Weights come from the reference's ``Model.init`` with every leaf that
starts at zero or at a constant (norm scales, token-shift mixes, decays,
skips, the bonus ``u``) set to numpy noise so that it counts, and are
carried across with ``convert.from_jax_params``.  Forward logits, prefill's
last-token logits and three greedy decode steps must agree to atol and rtol
1e-4 (a few layers at d 128 in float32, summed in another order by each
framework), with greedy ids equal.  An MoE layer's routing (``top_e``) must
equal the reference's before any logits are compared, so that a near-tie
shows as a routing difference and not as a numerical one; its aux values
(``lb_loss``, ``drop_frac``, ``expert_load``) must agree too, at
``expert_pad`` 1 and 16 and at a capacity factor that drops tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_transformer

from repro_torch import configs
from repro_torch.models import Model, convert
from repro_torch.models import moe, ssm
from repro_torch.models.transformer import segments

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
FAMILIES = ["deepseek_v2_236b", "granite_moe_3b_a800m", "zamba2_1_2b",
            "rwkv6_3b"]
MOE = ["deepseek_v2_236b", "granite_moe_3b_a800m"]
# (arch, expert_pad, capacity_factor): the MoE configs unpadded, padded to
# 16 (8 experts -> 16, half of them masked) and with a capacity that drops
CASES = [(a, pad, cf) for a in MOE for pad, cf in
         ((1, 1.25), (16, 1.25), (16, 0.25))] + \
    [(a, 16, 1.25) for a in FAMILIES if a not in MOE]
IDS = [f"{a}-pad{pad}-cf{cf}" for a, pad, cf in CASES]
# leaves the reference starts at zero or at a constant
_CONSTANT = {"ln1", "ln2", "ln", "final_norm", "bq", "bk", "bv", "q_norm",
             "kv_norm", "conv_b", "a_log", "dt_bias", "d_skip", "w0", "u",
             "ln_scale"}
_MIX = {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g"}


def _noisy_params(ref_model, seed):
    """The reference's float32 init, as numpy, with each constant leaf
    moved by N(0, 0.1) noise and the token-shift mixes drawn from U(0, 1)."""
    params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in _CONSTANT:
            leaf = (leaf + rng.normal(size=leaf.shape) * 0.1).astype(
                np.float32)
        elif name in _MIX:
            leaf = rng.uniform(size=leaf.shape).astype(np.float32)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _build(arch, expert_pad=16, capacity_factor=1.25, seed=0):
    cfg = configs.get_config(arch).reduced()
    ref = RefModel(cfg, expert_pad=expert_pad,
                   capacity_factor=capacity_factor)
    tree = _noisy_params(ref, seed)
    port = Model(cfg, device="cpu", dtype=torch.float32,
                 expert_pad=expert_pad, capacity_factor=capacity_factor)
    port.load_state_dict(convert.from_jax_params(cfg, tree))
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port, tokens


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


class _Routes:
    """Each MoE layer's ``top_e`` as the port and the reference compute it,
    in layer order: the port's through ``moe.route``, the reference's
    through a ``jax.debug.callback`` beside its ``jax.lax.top_k``."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        route, top_k = moe.route, jax.lax.top_k

        def port_route(*args):
            out = route(*args)
            self.port.append(out[2].numpy().copy())
            return out

        def ref_top_k(x, k):
            w, e = top_k(x, k)
            jax.debug.callback(lambda a: self.ref.append(np.asarray(a)), e,
                               ordered=True)
            return w, e

        monkeypatch.setattr(moe, "route", port_route)
        monkeypatch.setattr(ref_moe.jax.lax, "top_k", ref_top_k)

    def check(self, n_moe_layers):
        assert len(self.port) == len(self.ref) == n_moe_layers
        for i, (got, want) in enumerate(zip(self.port, self.ref)):
            np.testing.assert_array_equal(got, want, err_msg=f"layer {i}")


@pytest.mark.parametrize("arch,expert_pad,cf", CASES, ids=IDS)
def test_forward_matches_reference(monkeypatch, arch, expert_pad, cf):
    """Routing first, then the logits and the summed aux values."""
    cfg, ref, params, port, tokens = _build(arch, expert_pad, cf)
    routes = _Routes(monkeypatch)
    want, want_aux = ref._forward_aux(params, jnp.asarray(tokens))
    jax.block_until_ready(want)
    with torch.inference_mode():
        got, got_aux = port.forward_aux(torch.from_numpy(tokens))
    n_moe = sum(c for kind, c in segments(cfg) if kind == "moe")
    routes.check(n_moe)
    assert got.shape == want.shape == (B, S, port.padded_vocab)
    _close(got, want)
    for key in ("lb_loss", "drop_frac"):
        np.testing.assert_allclose(float(got_aux[key]),
                                   float(want_aux[key]), rtol=1e-6,
                                   err_msg=key)
    if cf < 1:
        assert float(got_aux["drop_frac"]) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_greedy_decode_match_reference(arch):
    """At the default expert padding and capacity factor."""
    cfg, ref, params, port, tokens = _build(arch, seed=3)
    max_len = S + 8
    want, rcache = ref.prefill(params, jnp.asarray(tokens),
                               ref.init_cache(B, max_len, dtype=jnp.float32))
    with torch.inference_mode():
        got, cache = port.prefill(torch.from_numpy(tokens),
                                  port.init_cache(B, max_len))
        _close(got, want)
        rtok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        tok = got[:, -1:].argmax(dim=-1)
        for i in range(3):
            assert tok.tolist() == np.asarray(rtok).tolist(), i
            want, rcache = ref.decode(params, rtok, rcache,
                                      jnp.asarray(S + i, jnp.int32))
            got, cache = port.decode(tok, cache, S + i)
            _close(got, want)
            rtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
            tok = got.argmax(dim=-1)
        assert tok.tolist() == np.asarray(rtok).tolist()


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("expert_pad", [1, 16])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_reference(arch, expert_pad, cf):
    """One MoE layer on noise: the output, lb_loss and drop_frac to float32
    rounding, expert_load exactly; at capacity factor 0.25 tokens drop."""
    cfg, ref, params, port, _ = _build(arch, expert_pad, cf, seed=5)
    p = port.layers[-1].moe
    ref_p = jax.tree.map(lambda a: a[-1], params["segments"][-1]["moe"])
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want, want_aux = ref_moe.moe_forward(ref_p, cfg, jnp.asarray(x),
                                         ref.padded_experts, cf)
    with torch.inference_mode():
        got, got_aux = moe.moe_forward(p, cfg, torch.from_numpy(x),
                                       port.padded_experts, cf)
    _close(got, want)
    np.testing.assert_array_equal(got_aux["expert_load"].numpy(),
                                  np.asarray(want_aux["expert_load"]))
    assert got_aux["expert_load"].shape == (port.padded_experts,)
    np.testing.assert_allclose(float(got_aux["lb_loss"]),
                               float(want_aux["lb_loss"]), rtol=1e-6)
    assert float(got_aux["drop_frac"]) == float(want_aux["drop_frac"])
    if cf < 1:
        assert float(got_aux["drop_frac"]) > 0
    if expert_pad > cfg.n_experts:           # padding experts take nothing
        assert int(got_aux["expert_load"][cfg.n_experts:].sum()) == 0


def test_capacity_is_the_reference_formula():
    """``max(8, int(t k cf / E + 0.999) // 8 * 8 + 8)`` slots an expert."""
    cfg = configs.get_config("granite_moe_3b_a800m")
    # Granite at B 2 x S 4096, 40 experts padded to 48, top-8
    assert moe.capacity(8192, cfg, 48, 1.25) == 1712
    assert moe.capacity(8192, cfg, 48, 0.25) == 344
    assert moe.capacity(4, cfg, 48, 1.25) == 8


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1_2b"])
def test_decode_reproduces_forward(arch):
    """Forward's last-token logits equal those of a prefill of the first
    half followed by step-by-step decode of the rest (the reference's
    ``tests/test_models.py`` check), in the port and against the
    reference's forward."""
    cfg, ref, params, port, tokens = _build(arch, seed=7)
    want = ref.forward(params, jnp.asarray(tokens))
    half = S // 2
    with torch.inference_mode():
        full = port(torch.from_numpy(tokens))
        _close(full, want)
        t = torch.from_numpy(tokens).long()
        logits, cache = port.prefill(t[:, :half], port.init_cache(B, S + 4))
        for i in range(half, S):
            logits, cache = port.decode(t[:, i:i + 1], cache, i)
    torch.testing.assert_close(logits[:, 0], full[:, -1], **TOL)


@pytest.mark.parametrize("mixer", ["mamba2", "rwkv6"])
def test_mixer_decode_matches_reference(mixer):
    """The first layer's mixer, one token at a time from a zero state:
    ``mamba2_decode`` / ``rwkv6_decode`` against the reference's, outputs
    and carried states, for four steps."""
    arch, key = {"mamba2": ("zamba2_1_2b", "mixer"),
                 "rwkv6": ("rwkv6_3b", "tm")}[mixer]
    cfg, ref, params, port, _ = _build(arch, seed=9)
    ref_p = jax.tree.map(lambda a: a[0], params["segments"][0][key])
    p = getattr(port.layers[0], key)
    decode, ref_decode = (getattr(ssm, f"{mixer}_decode"),
                          getattr(ref_ssm, f"{mixer}_decode"))
    init, ref_init = ((ssm.init_mamba2_state, ref_ssm.init_mamba2_state)
                      if mixer == "mamba2" else
                      (ssm.init_rwkv6_state, ref_ssm.init_rwkv6_state))
    state = init(cfg, B, torch.float32, "cpu")
    ref_state = ref_init(cfg, B, jnp.float32)
    x = np.random.default_rng(10).normal(size=(B, 4, cfg.d_model)).astype(
        np.float32)
    with torch.inference_mode():
        for i in range(4):
            xi = x[:, i:i + 1]
            want, ref_state = ref_decode(ref_p, cfg, jnp.asarray(xi),
                                         ref_state)
            got, state = decode(p, cfg, torch.from_numpy(xi), state)
            _close(got, want)
            for a, b in zip(state, ref_state):
                _close(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_params_takes_every_leaf(arch):
    """``load_state_dict(strict=True)`` takes every leaf of the reference's
    tree into a bf16 model, and the leaves the reference keeps in float32
    stay float32 there."""
    cfg = configs.get_config(arch).reduced()
    ref = RefModel(cfg)
    tree = _noisy_params(ref, 0)
    state = convert.from_jax_params(cfg, tree)
    # each layer of a stacked leaf, and every unstacked leaf
    assert len(state) == sum(
        leaf.shape[0] for seg in tree["segments"]
        for leaf in jax.tree.leaves(seg)) + len(jax.tree.leaves(
            {k: v for k, v in tree.items() if k != "segments"}))
    port = Model(cfg, device="cpu", dtype=torch.bfloat16)
    port.load_state_dict(state, strict=True)
    got = port.state_dict()
    assert sorted(got) == sorted(state)
    for name, w in got.items():
        f32 = name.rsplit(".", 1)[-1] in {"a_log", "dt_bias", "d_skip",
                                          "w0", "u", "ln_scale"}
        assert w.dtype == (torch.float32 if f32 else torch.bfloat16), name
        torch.testing.assert_close(w.float(), state[name].to(w.dtype).float(),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_init_shapes_and_dtypes_equal_reference(arch):
    """Every parameter of a bf16 model has the shape and dtype of the
    reference's ``Model.init(key, bfloat16)`` leaf it stands for."""
    cfg = configs.get_config(arch).reduced()
    ref = RefModel(cfg)
    shapes = jax.eval_shape(lambda k: ref.init(k, dtype=jnp.bfloat16),
                            jax.random.PRNGKey(0))
    want = {}
    for (kind, count), seg in zip(segments(cfg), shapes["segments"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(seg)[0]:
            name = ".".join(str(k.key) for k in path)
            for i in range(count):
                want.setdefault(i, {})[name] = (leaf.shape[1:], leaf.dtype)
    port = Model(cfg, device="cpu", dtype=torch.bfloat16)
    assert segments(cfg) == ref_transformer._segments(cfg)
    got = {n: (tuple(w.shape), w.dtype) for n, w in port.state_dict().items()}
    first = 0
    for (kind, count), seg in zip(segments(cfg), shapes["segments"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(seg)[0]:
            name = ".".join(str(k.key) for k in path)
            for i in range(first, first + count):
                shape, dt = got.pop(f"layers.{i}.{name}")
                assert shape == leaf.shape[1:], name
                assert str(dt).split(".")[-1] == str(leaf.dtype), name
        first += count
    rest = {k: v for k, v in shapes.items() if k != "segments"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rest)[0]:
        name = ".".join(str(k.key) for k in path)
        shape, dt = got.pop(name)
        assert shape == leaf.shape and \
            str(dt).split(".")[-1] == str(leaf.dtype), name
    assert not got, sorted(got)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_segments_equal_reference_at_full_size(arch):
    cfg = configs.get_config(arch)
    assert segments(cfg) == ref_transformer._segments(cfg)


def test_shared_block_goes_between_segments_only():
    """zamba2 at full size: 38 layers in segments of 6 (the last of 2), so
    the shared block runs 6 times, after layers 5, 11, ..., 35, with a KV
    cache per application."""
    cfg = dataclasses.replace(configs.get_config("zamba2_1_2b"), d_model=64,
                              n_heads=1, n_kv_heads=1, head_dim=64, d_ff=64,
                              vocab=64, ssm_state=8)
    port = Model(cfg, device="cpu", dtype=torch.float32)
    assert port.shared_after == (5, 11, 17, 23, 29, 35)
    cache = port.init_cache(1, 4)
    assert len(cache["layers"]) == 38 and len(cache["shared"]) == 6
