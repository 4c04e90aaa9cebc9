"""The port's dense-GQA language model (repro_torch.models) against the
reference's (repro.models), on the CPU at reduced sizes.

Weights come from the reference's ``Model.init`` in float32, with the norm
scales and QKV biases (zero at init) set to numpy noise so that they count,
and are carried across with ``convert.from_jax_params``.  Forward logits
(with and without the flash-attention path), prefill's last-token logits and
three greedy decode steps must agree to atol and rtol 1e-4: 2 layers at
d 128 in float32, summed in another order by each framework.  Greedy token
ids must be equal.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import Model as RefModel

from repro_torch import configs
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.launch import serve_lm
from repro_torch.models import Model, convert

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
DENSE = [a for a in configs.ARCH_IDS
         if configs.get_config(a).family in ("dense", "audio", "vlm")
         and not configs.get_config(a).use_mla]
# reduced configs have GQA group 1 (or MQA); this one has group 2 and a
# padded vocabulary
CUSTOM = ("custom_gqa2", dataclasses.replace(
    configs.get_config("mistral_nemo_12b").reduced(), name="custom-gqa2",
    n_kv_heads=2, vocab=500, qkv_bias=True), 64)
CASES = [(a, configs.get_config(a).reduced(), 1) for a in DENSE] + [CUSTOM]


def _noisy_params(ref_model, seed):
    """The reference's float32 init, with every norm scale and bias set to
    numpy noise, as numpy."""
    params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            leaf = (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _build(cfg, vocab_pad, seed=0):
    ref = RefModel(cfg, expert_pad=1, vocab_pad=vocab_pad)
    tree = _noisy_params(ref, seed)
    port = Model(cfg, device="cpu", dtype=torch.float32, vocab_pad=vocab_pad)
    port.load_state_dict(convert.from_jax_params(cfg, tree))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": rng.normal(size=(B, cfg.n_prefix, cfg.d_model))
                 .astype(np.float32)}
    return ref, jax.tree.map(jnp.asarray, tree), port, tokens, extra


def _jx(extra):
    return None if extra is None else {k: jnp.asarray(v)
                                       for k, v in extra.items()}


def _tx(extra):
    return None if extra is None else {k: torch.from_numpy(v)
                                       for k, v in extra.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name,cfg,vocab_pad", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_reference(name, cfg, vocab_pad, flash):
    """Logits of the whole sequence; with ``flash`` both run their blocked
    attention path (the reference's Pallas kernel in interpret mode, the
    port's plain version), except paligemma, whose prefix keeps both on the
    dense path."""
    ref, params, port, tokens, extra = _build(cfg, vocab_pad)
    ref.use_flash_kernel = flash
    port.use_flash_kernel = flash
    want = ref.forward(params, jnp.asarray(tokens), extra=_jx(extra))
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens), extra=_tx(extra))
    assert got.shape == want.shape == (B, S + cfg.n_prefix,
                                       port.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("name,cfg,vocab_pad", CASES, ids=[c[0] for c in CASES])
def test_prefill_and_greedy_decode_match_reference(name, cfg, vocab_pad):
    ref, params, port, tokens, extra = _build(cfg, vocab_pad, seed=3)
    max_len = cfg.n_prefix + S + 8
    want, rcache = ref.prefill(params, jnp.asarray(tokens),
                               ref.init_cache(B, max_len, dtype=jnp.float32),
                               extra=_jx(extra))
    with torch.inference_mode():
        got, cache = port.prefill(torch.from_numpy(tokens),
                                  port.init_cache(B, max_len), extra=_tx(extra))
        _close(got, want)
        pos = cfg.n_prefix + S
        rtok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        tok = got[:, -1:].argmax(dim=-1)
        for i in range(3):
            assert tok.tolist() == np.asarray(rtok).tolist(), i
            want, rcache = ref.decode(params, rtok, rcache,
                                      jnp.asarray(pos + i, jnp.int32))
            got, cache = port.decode(tok, cache, pos + i)
            _close(got, want)
            rtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
            tok = got.argmax(dim=-1)
        assert tok.tolist() == np.asarray(rtok).tolist()


def test_forward_last_token_equals_prefill():
    _, _, port, tokens, extra = _build(CUSTOM[1], CUSTOM[2], seed=5)
    with torch.inference_mode():
        full = port(torch.from_numpy(tokens))
        last, _ = port.prefill(torch.from_numpy(tokens),
                               port.init_cache(B, S + 4))
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)


def test_vocab_pad_is_masked():
    _, _, port, tokens, _ = _build(CUSTOM[1], CUSTOM[2])
    with torch.inference_mode():
        logits = port(torch.from_numpy(tokens))
    assert port.padded_vocab == 512
    assert bool((logits[..., 500:] == -1e30).all())
    assert bool((logits[..., :500] > -1e29).all())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    got, want = configs.get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.hd == want.hd
    for shape in configs.SHAPES:
        assert configs.cell_enabled(got, shape) == \
            ref_configs.cell_enabled(want, shape)


def test_config_tables_equal_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.SHAPES == ref_configs.SHAPES
    assert list(configs.iter_cells()) == list(ref_configs.iter_cells())
    assert [f.name for f in dataclasses.fields(configs.get_config(
        "gemma_7b"))] == [f.name for f in dataclasses.fields(
            ref_configs.get_config("gemma_7b"))]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_arch_builds(arch):
    """All ten assigned architectures build as a port ``Model`` and run a
    forward; the MoE, MLA and SSM families are held against the reference
    in ``test_torch_model_families.py``."""
    cfg = configs.get_config(arch).reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32)
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": torch.zeros((1, cfg.n_prefix, cfg.d_model))}
    with torch.inference_mode():
        logits = model(torch.zeros((1, 4), dtype=torch.int64), extra=extra)
    assert logits.shape == (1, 4 + cfg.n_prefix, model.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_dense_archs_are_the_six():
    assert DENSE == ["mistral_nemo_12b", "phi3_mini_3_8b", "qwen1_5_110b",
                     "gemma_7b", "musicgen_large", "paligemma_3b"]


def test_converter_refuses_integer_arrays():
    cfg = CUSTOM[1]
    tree = _noisy_params(RefModel(cfg, vocab_pad=64), 0)
    tree["embed"] = tree["embed"].astype(np.int32)
    with pytest.raises(TypeError):
        convert.from_jax_params(cfg, tree)


def test_generate_on_cpu():
    """Prefill, the argmax first token, then seeded sampling: shape, range,
    the first token equal to prefill's argmax, and the same ids again from
    the same generator seed."""
    cfg = CUSTOM[1]
    _, _, port, tokens, _ = _build(cfg, CUSTOM[2], seed=7)
    prompts = torch.from_numpy(tokens).long()
    runs = [serve_lm.generate(port, prompts, 6, 0.8,
                              torch.Generator().manual_seed(1))
            for _ in range(2)]
    ids = runs[0].tokens
    assert ids.shape == (B, 6) and ids.dtype == torch.int64
    assert bool(((ids >= 0) & (ids < cfg.vocab)).all())
    assert torch.equal(ids, runs[1].tokens)
    with torch.inference_mode():
        first, _ = port.prefill(prompts, port.init_cache(B, S + 2))
    assert torch.equal(ids[:, 0], first[:, -1].argmax(dim=-1))
    assert runs[0].prefill_s > 0 and runs[0].decode_s > 0


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, the model, the serving CLI and the 32-bit join probe
    raise unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CUSTOM[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main(["--tokens", "2"])
    keys = torch.arange(10, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hp.hash_join_probe(keys, keys, keys)
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_serve_cli_on_cpu(capsys):
    gen = serve_lm.main(["--arch", "gemma_7b", "--batch", "2",
                         "--prompt-len", "8", "--tokens", "4",
                         "--device", "cpu"])
    assert gen.tokens.shape == (2, 4)
    assert "gemma-7b (reduced)" in capsys.readouterr().out


def test_first_forward_of_a_fresh_process_equals_the_second():
    """Fault C4 (ROADMAP): a fresh process builds the card test's reduced
    model (group 2, float32) on the CPU and runs forward three times; the
    first must equal the second and the third bit for bit, at every
    recorded step.  ``tools/cpu_first_forward.py`` runs the same child in
    many processes."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "cpu_first_forward.py"),
         "--child", "--src", str(root / "src")], capture_output=True,
        text=True, check=True, timeout=600).stdout.strip().splitlines()[-1]
    res = json.loads(out)
    assert res["first_parting"] is None, res
    assert res["max_abs"] == 0.0 and res["later_equal"]
    assert res["query_product"]["equal"]
