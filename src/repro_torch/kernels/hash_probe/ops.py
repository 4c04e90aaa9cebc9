"""Public wrapper: bucket-table build (plain PyTorch) + the 64-bit probe.

The build stays plain PyTorch, as the reference builds it outside Pallas: one
stable lexicographic sort by (bucket, key), written as two stable argsorts
(least significant key first), then a dedup and a rank within each bucket.
A bucket holding more than ``cap`` distinct keys raises the overflow flag, so
the caller re-executes with larger buckets (the runner's capacity factor).

``hash_probe64`` launches ``csrc/hash_probe.cu`` on a CUDA tensor and runs
the plain version (``ref.hash_probe64_ref``) on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from .ref import bucket_of, hash_probe64_ref, murmur32, split64

__all__ = ["SENTINEL", "next_pow2", "build_bucket_table64", "hash_probe64",
           "bucket_of", "murmur32", "split64"]

SENTINEL = -2147483648          # empty lane of both key planes
_c = ctypes.c_void_p
_SIGNATURES = {"hash_probe64": [_c, ctypes.c_longlong, _c, _c, _c,
                                ctypes.c_int, ctypes.c_int, _c, _c]}


def next_pow2(x: int) -> int:
    """Smallest power of two >= x, at least 8 (bucket sizing)."""
    return 1 << max(3, (x - 1).bit_length())


def build_bucket_table64(keys: torch.Tensor, vals: torch.Tensor, buckets: int,
                         cap: int = 16, valid: torch.Tensor | None = None):
    """(m,) int64 keys -> ((B,C) lo, (B,C) hi, (B,C) vals, overflowed).

    Invalid rows (``valid`` False) go to a virtual bucket and are dropped.
    Duplicate keys are kept once (their first row), so membership probes
    accept non-unique build sides without inflating a bucket.
    """
    dev = keys.device
    m = keys.shape[0]
    k64 = keys.to(torch.int64)
    lo, hi = split64(k64)
    b = bucket_of(lo, hi, buckets)
    if valid is not None:
        b = torch.where(valid, b, buckets)          # virtual bucket: dropped
    by_key = torch.argsort(k64, stable=True)
    order = by_key[torch.argsort(b[by_key], stable=True)]
    sb, sk = b[order], k64[order]
    in_bucket = sb < buckets
    dup = torch.zeros(m, dtype=torch.bool, device=dev)
    dup[1:] = (sb[1:] == sb[:-1]) & (sk[1:] == sk[:-1])
    keep = in_bucket & ~dup
    counts = torch.zeros(buckets + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, sb, keep.to(torch.int64))[:buckets]
    start = torch.zeros(buckets + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(counts, 0)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1   # rank among kept
    slot = rank - start[sb.clamp(max=buckets)]
    ok = keep & (slot < cap)
    flat = torch.where(ok, sb * cap + slot.clamp(max=cap - 1), buckets * cap)

    def plane(fill: int, src: torch.Tensor) -> torch.Tensor:
        # one extra slot absorbs every dropped row, then is cut off
        out = torch.full((buckets * cap + 1,), fill, dtype=torch.int32,
                         device=dev)
        out[flat] = src.to(torch.int32)
        return out[:-1].reshape(buckets, cap)

    return (plane(SENTINEL, lo[order]), plane(SENTINEL, hi[order]),
            plane(-1, vals[order]), (counts > cap).any())


def hash_probe64(probe_keys: torch.Tensor, bk_lo: torch.Tensor,
                 bk_hi: torch.Tensor, bvals: torch.Tensor) -> torch.Tensor:
    """(n,) int64 probe keys vs a 64-bit bucket table -> build row or -1
    (int32).  The table is one made by :func:`build_bucket_table64` from
    non-negative build rows: lanes fill front to back and -1 marks an empty
    lane, which lets the kernel stop a bucket's scan early."""
    if bk_lo.ndim != 2 or not bk_lo.shape == bk_hi.shape == bvals.shape:
        raise ValueError("hash_probe64: bucket planes must share one (B, C) "
                         "shape")
    if probe_keys.device.type == "cpu":
        return hash_probe64_ref(probe_keys, bk_lo, bk_hi, bvals)
    if probe_keys.device.type != "cuda":
        raise ValueError(f"hash_probe64: unsupported device {probe_keys.device}")
    keys = probe_keys.to(torch.int64).contiguous()
    for t in (bk_lo, bk_hi, bvals):
        if t.dtype != torch.int32 or t.device != keys.device:
            raise TypeError("hash_probe64: bucket planes must be int32 on "
                            "the probe keys' device")
    bk_lo, bk_hi, bvals = (t.contiguous() for t in (bk_lo, bk_hi, bvals))
    buckets, cap = bk_lo.shape
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    lib = K.load("hash_probe", _SIGNATURES)
    with torch.cuda.device(keys.device):
        rc = lib.hash_probe64(K.ptr(keys), keys.shape[0], K.ptr(bk_lo),
                              K.ptr(bk_hi), K.ptr(bvals), buckets, cap,
                              K.ptr(out), K.stream_of(keys))
    K.check(lib, rc, "hash_probe64")
    K.count_launch("hash_probe64")
    return out
