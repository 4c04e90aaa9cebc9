"""Public wrapper: (B, H, S, D) layout and GQA flattening.

``flash_attention`` flattens (batch, heads) as the reference's wrapper does:
query head ``bh`` of the flattened ``B * Hq`` reads kv head ``bh // group``
of the flattened ``B * Hkv``.  On a CUDA tensor it launches
``csrc/flash_attention.cu``; on a CPU tensor it runs the plain version
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

__all__ = ["HEAD_DIMS", "flash_attention", "attention_ref"]

HEAD_DIMS = (32, 64, 96, 128, 256)      # the kernel's template instances
_DTYPES = (torch.float32, torch.bfloat16)
_c = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {"flash_attention": [_i, _c, _c, _c, _c, _i, _i, _i, _i, _i,
                                   _i, _c]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype.

    ``causal`` masks key ``j`` from query ``i`` when ``i < j`` (top-left
    aligned, as the reference).  Hq must be a multiple of Hkv."""
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not form "
                         f"(B, Hq, Sq, D) / (B, Hkv, Skv, D) with Hkv | Hq")
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
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(K.dtype_code(q.dtype), K.ptr(q), K.ptr(k),
                                 K.ptr(v), K.ptr(out), b * hq, hq // hkv, sq,
                                 skv, d, int(causal), K.stream_of(q))
    K.check(lib, rc, "flash_attention")
    K.count_launch("flash_attention")
    return out
