"""Plain PyTorch versions of the 64-bit and 32-bit bucket probes, the bucket
hash, and the reference's sorted-build oracle of the 32-bit join probe.

The bucket hash combines the key's two 32-bit planes through ``murmur32``
(``kernels/radix_hist/ref.py``, shared with the partition histogram), all in
int64 with masks, since torch on the CPU has no ``>>`` or ``%`` for
``uint32``/``uint64``.  Bit-exact with
``repro.kernels.hash_probe.kernel.bucket_of`` and with its CUDA twin in
``csrc/common.cuh``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.radix_hist.ref import murmur32, u32

_M32 = 0xFFFFFFFF


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


def hash_probe64_ref(probe_keys: torch.Tensor, heads: torch.Tensor,
                     tails: torch.Tensor) -> torch.Tensor:
    """(n,) int64 probe keys vs a 64-bit bucket table ((B, 8) int32 heads:
    two keys, their rows, the key count n and the start of keys 3..n in
    the (R, 2) int64 (key, row) ``tails``) -> build row or -1 (int32):
    the matching key among the bucket's n."""
    keys = probe_keys.to(torch.int64)
    lo, hi = split64(keys)
    h = heads[bucket_of(lo, hi, heads.shape[0])]                # (n, 8)
    count, start = h[:, 6].to(torch.int64), h[:, 7].to(torch.int64)
    neg = torch.full((), -1, dtype=torch.int64, device=keys.device)
    lane = torch.arange(2, device=keys.device)
    hit = (lane < count[:, None]) & \
        (h.view(torch.int64)[:, :2] == keys[:, None])
    row = torch.where(hit, h[:, 4:6].to(torch.int64), neg).amax(dim=1)
    # the rest of the bucket, only where the head did not answer
    need = torch.nonzero((row < 0) & (count > 2)).squeeze(1)
    if need.numel():
        width = int(count[need].max()) - 2
        further = torch.arange(width, device=keys.device)
        idx = start[need, None] + further
        inside = further < (count[need] - 2)[:, None]           # (k, width)
        e = tails[idx.clamp(max=tails.shape[0] - 1)]            # (k, width, 2)
        hit = inside & (e[..., 0] == keys[need, None])
        row[need] = torch.where(hit, e[..., 1], neg).amax(dim=1)
    return row.to(torch.int32)


def bucket_of32(keys: torch.Tensor, buckets: int) -> torch.Tensor:
    """Bucket id (int64) of an int32 key: ``murmur32(key) % buckets``, as the
    reference's 32-bit build and probe hash it."""
    return murmur32(keys) % buckets


def hash_probe32_ref(probe_keys: torch.Tensor, bkeys: torch.Tensor,
                     bvals: torch.Tensor,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) int32 probe keys vs a (B, C) int32 bucket table -> the largest
    matching build row or -1, the max over all C lanes (int32), or over the
    first ``counts[b]`` lanes of bucket b where fill counts are given."""
    keys = probe_keys.to(torch.int32)
    b = bucket_of32(keys, bkeys.shape[0])
    hit = bkeys[b] == keys[:, None]                               # (n, C)
    if counts is not None:
        lane = torch.arange(bkeys.shape[1], device=bkeys.device)
        hit &= lane < counts[b][:, None]
    neg = torch.full((), -1, dtype=bvals.dtype, device=bvals.device)
    return torch.where(hit, bvals[b], neg).amax(dim=1)


def hash_probe_ref(probe_keys: torch.Tensor, build_keys: torch.Tensor,
                   build_vals: torch.Tensor) -> torch.Tensor:
    """The reference's oracle of the join probe: probe (n,) against unique
    build keys (m,) through a sorted build and a binary search -> the
    matched build value or -1 (int32)."""
    order = torch.argsort(build_keys)
    sk, sv = build_keys[order], build_vals[order]
    pos = torch.searchsorted(sk, probe_keys.to(sk.dtype)) \
        .clamp(0, sk.shape[0] - 1)
    hit = sk[pos] == probe_keys
    return torch.where(hit, sv[pos], -1).to(torch.int32)
