"""Public wrapper: (B, H, S, D) layout and GQA flattening.

``flash_attention`` flattens (batch, heads) as the reference's wrapper does:
query head ``bh`` of the flattened ``B * Hq`` reads kv head ``bh // group``
of the flattened ``B * Hkv``.  On a CUDA tensor it launches one of the two
designs of ``csrc/flash_attention.cu``, chosen by :func:`design` from the
dtype and the head size alone: bf16 at head sizes 64, 128 and 256 runs on
the tensor cores (``wgmma``, TMA), everything else on the CUDA cores in
float32.  On a CPU tensor it runs the plain version
(``ref.attention_ref``).  The reference's ``use_kernel=``, ``interpret=``,
``q_blk=`` and ``kv_blk=`` were TPU-era arguments and are not carried over:
the kernel picks its tiles from the head size, and masks a ragged sequence
itself where the reference asserted divisibility.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "WGMMA_HEAD_DIMS", "design", "flash_attention",
           "attention_ref"]

HEAD_DIMS = (32, 64, 96, 128, 256)      # the CUDA-core kernel's instances
WGMMA_HEAD_DIMS = (64, 128, 256)        # the tensor-core kernel's, bf16 only
_DTYPES = (torch.float32, torch.bfloat16)
_c = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {"flash_attention": [_i, _c, _c, _c, _c, _i, _i, _i, _i, _i,
                                   _i, _c],
               "flash_attention_wgmma": [_c, _c, _c, _c, _i, _i, _i, _i, _i,
                                         _i, _c]}


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of (dtype, head size) launches: ``"wgmma"``
    (bf16 on the tensor cores) or ``"cuda_cores"`` (float32 arithmetic)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base is 16-byte aligned (what a TMA tensor map
    needs), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype.

    ``causal`` masks key ``j`` from query ``i`` when ``i < j`` (top-left
    aligned, as the reference).  Hq must be a multiple of Hkv.  Forward
    only: asked for a gradient (grad mode on and q, k or v requiring it)
    it raises, on the CPU as on the card."""
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not form "
                         f"(B, Hq, Sq, D) / (B, Hkv, Skv, D) with Hkv | Hq")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # on the card the result is written into a tensor with no grad_fn,
        # which would drop the gradients of q, k and v without a word
        raise RuntimeError(
            "flash_attention has no backward: the reference defines no "
            "backward kernel and trains through the plain attention "
            "(Model(use_flash_kernel=False)); call it under torch.no_grad() "
            "or on tensors that do not require grad")
    if q.device.type == "cpu":
        o = attention_ref(q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d),
                          v.reshape(b * hkv, skv, d), causal=causal)
        return o.reshape(b, hq, sq, d)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention: no keys to attend to")
    lib = K.load("flash_attention", _SIGNATURES)
    kind = design(q.dtype, d)
    with torch.cuda.device(q.device):
        if kind == "wgmma":
            q, k, v = (_aligned(t) for t in (q, k, v))
            rc = lib.flash_attention_wgmma(
                K.ptr(q), K.ptr(k), K.ptr(v), K.ptr(out), b * hq, hq // hkv,
                sq, skv, d, int(causal), K.stream_of(q))
        else:
            rc = lib.flash_attention(
                K.dtype_code(q.dtype), K.ptr(q), K.ptr(k), K.ptr(v),
                K.ptr(out), b * hq, hq // hkv, sq, skv, d, int(causal),
                K.stream_of(q))
    K.check(lib, rc, f"flash_attention ({kind})")
    K.count_launch("flash_attention")
    if kind == "wgmma":
        K.count_launch("flash_attention_wgmma")
    return out
