"""The port's flash attention (repro_torch.kernels.flash_attention) against
the reference's, on the CPU.

On a CPU tensor the wrapper runs its plain version; it must equal the
reference's jnp oracle (``use_kernel=False``) and its Pallas kernel run in
interpret mode, as ``tests/test_kernels.py`` runs it, to atol and rtol
1e-5 in float32 (the same arithmetic, summed in another order).  Causal and
full attention, GQA groups 1, 2 and 4, sequences that are no multiple of 64,
and a query block shorter than the keys.  The CUDA kernel is held against
the plain version on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import ops as fa_ref

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_plain

TOL = dict(atol=1e-5, rtol=1e-5)

# (b, hq, hkv, sq, skv, d, blk): blk divides sq and skv for the Pallas leg
SHAPES = [
    (1, 2, 2, 64, 64, 32, 32),        # group 1
    (2, 4, 2, 40, 40, 64, 20),        # group 2, S not a multiple of 64
    (1, 8, 2, 100, 100, 32, 25),      # group 4, ragged
    (2, 4, 1, 96, 96, 128, 32),       # MQA, head 128
    (1, 4, 1, 48, 96, 32, 48),        # Sq < Skv
]


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_reference_oracle_and_pallas(shape, causal):
    b, hq, hkv, sq, skv, d, blk = shape
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + d + int(causal))
    K.reset_launches()
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert K.launches["flash_attention"] == 0      # the CPU runs the plain one
    assert got.shape == (b, hq, sq, d) and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    oracle = fa_ref.flash_attention(jq, jk, jv, causal=causal,
                                    use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    pallas = fa_ref.flash_attention(jq, jk, jv, causal=causal, q_blk=blk,
                                    kv_blk=blk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_gqa_head_map():
    """Flattened query head bh reads kv head bh // group: each query head
    equals single-head attention against its own kv head."""
    b, hq, hkv, s, d = 2, 4, 2, 24, 32
    q, k, v = map(torch.from_numpy, _inputs(b, hq, hkv, s, s, d, seed=1))
    got = fa.flash_attention(q, k, v)
    for bi in range(b):
        for h in range(hq):
            one = fa_plain.attention_ref(q[bi, h][None], k[bi, h // 2][None],
                                         v[bi, h // 2][None])
            torch.testing.assert_close(got[bi, h], one[0], **TOL)


def test_output_keeps_q_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 2, 1, 16, 16, 32, seed=2))
    assert fa.flash_attention(q, k, v).dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["heads", "dim", "batch"])
def test_rejects_mismatched_shapes(bad):
    q = torch.zeros(2, 4, 8, 32)
    k = torch.zeros(2, 2, 8, 32)
    if bad == "heads":
        k = torch.zeros(2, 3, 8, 32)
    elif bad == "dim":
        k = torch.zeros(2, 2, 8, 64)
    else:
        k = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k.clone())


def test_rejects_other_devices():
    q = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 32, "cuda_cores"),
    (torch.bfloat16, 96, "cuda_cores"), (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"), (torch.float32, 256, "cuda_cores")])
def test_design_is_chosen_by_dtype_and_head_size(dtype, d, want):
    """bf16 at the tensor-core kernel's head sizes runs it; every float32
    call and the other head sizes run the CUDA-core kernel.  Each launch
    counts under flash_attention, the tensor-core ones also under their own
    counter."""
    assert fa.design(dtype, d) == want
    assert d in fa.HEAD_DIMS
    assert (d in fa.WGMMA_HEAD_DIMS and dtype == torch.bfloat16) == \
        (want == "wgmma")
    assert {"flash_attention", "flash_attention_wgmma"} <= set(K.KERNELS)
