"""Plain PyTorch versions: the murmur hashes and the 64-bit bucket probe.

torch on the CPU has no ``>>`` or ``%`` for ``uint32``/``uint64``, so the
unsigned 32-bit arithmetic of ``murmur32`` runs in int64 on values kept in
``[0, 2^32)`` by ``& 0xFFFFFFFF`` masks.  An int64 product of two such values
wraps modulo 2^64, which leaves its low 32 bits exact.  Bit-exact with
``repro.kernels.radix_hist.kernel.murmur32`` and
``repro.kernels.hash_probe.kernel.bucket_of``, and with their CUDA twins in
``csrc/common.cuh``.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) bits -> their uint32 value, as int64."""
    return x.to(torch.int64) & _M32


def murmur32(k: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of the low 32 bits of ``k``; int64 in [0, 2^32)."""
    k = u32(k)
    k = k ^ (k >> 16)
    k = (k * 0x85EBCA6B) & _M32
    k = k ^ (k >> 13)
    k = (k * 0xC2B2AE35) & _M32
    return k ^ (k >> 16)


def split64(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (lo, hi) int32 planes, bit-exact with the reference's
    ``_split64`` (lo is the low word's bits read as a signed int32)."""
    k = keys.to(torch.int64)
    lo = (((k & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    hi = (k >> 32).to(torch.int32)
    return lo, hi


def bucket_of(lo: torch.Tensor, hi: torch.Tensor, buckets: int
              ) -> torch.Tensor:
    """Bucket id (int64) of a 64-bit key split into (lo, hi) planes."""
    mixed = murmur32(hi) ^ u32(lo)
    return murmur32(mixed) % buckets


def hash_probe64_ref(probe_keys: torch.Tensor, bk_lo: torch.Tensor,
                     bk_hi: torch.Tensor, bvals: torch.Tensor) -> torch.Tensor:
    """(n,) int64 probe keys vs a (B, C) bucket table -> build row or -1."""
    lo, hi = split64(probe_keys)
    b = bucket_of(lo, hi, bk_lo.shape[0])
    hit = (bk_lo[b] == lo[:, None]) & (bk_hi[b] == hi[:, None])   # (n, C)
    neg = torch.full((), -1, dtype=bvals.dtype, device=bvals.device)
    return torch.where(hit, bvals[b], neg).amax(dim=1)
