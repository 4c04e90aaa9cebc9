"""Plain PyTorch versions: murmur32, the partition histogram and the counting
rank.

torch on the CPU has no ``>>`` or ``%`` for ``uint32``, so the unsigned
32-bit arithmetic runs in int64 on values kept in ``[0, 2^32)`` by
``& 0xFFFFFFFF`` masks.  An int64 product of two such values wraps modulo
2^64, which leaves its low 32 bits exact.  ``murmur32`` is bit-exact with
``repro.kernels.radix_hist.kernel.murmur32`` and with its CUDA twin in
``csrc/common.cuh``; the 64-bit bucket hash of ``kernels/hash_probe`` is
built on it.

A key ``k`` falls in bin ``murmur32(k) % parts`` (hashed) or
``uint32(k) % parts``, as in the reference's ``_bin``.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
RANK_BLK = 2048          # rows per block of the plain counting rank


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


def bin_of(keys: torch.Tensor, parts: int, hashed: bool) -> torch.Tensor:
    """Partition bin (int64 in [0, parts)) of each int32 key."""
    return (murmur32(keys) if hashed else u32(keys)) % parts


def radix_hist_ref(keys: torch.Tensor, parts: int, blk: int,
                   hashed: bool = True) -> torch.Tensor:
    """(n,) keys, n a multiple of ``blk`` -> (n // blk, parts) float32
    per-block histograms."""
    nb = keys.shape[0] // blk
    block = torch.arange(keys.shape[0], device=keys.device) // blk
    flat = block * parts + bin_of(keys, parts, hashed)
    return torch.bincount(flat, minlength=nb * parts) \
        .reshape(nb, parts).to(torch.float32)


def radix_hist_plain(keys: torch.Tensor, parts: int, blk: int,
                     hashed: bool = True) -> torch.Tensor:
    """(n,) keys, any n -> (ceil(n / blk), parts) float32, as the reference's
    wrapper computes it: pad the last block with the first key, bin, then
    subtract the pad from that key's bin.  ``blk`` is the effective block
    (``ops.radix_hist`` clamps it for small n)."""
    n = keys.shape[0]
    pad = (n + blk - 1) // blk * blk - n
    k32 = keys.to(torch.int32)
    hist = radix_hist_ref(torch.cat([k32, k32[:1].expand(pad)]), parts, blk,
                          hashed=hashed)
    if pad:
        hist[-1, bin_of(k32[:1], parts, hashed)[0]] -= float(pad)
    return hist


def counting_rank_ref(keys: torch.Tensor, parts: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's oracle leg: keys (n,) in [0, parts) -> (slot (n,)
    int32, counts (parts,) int32), ``slot[i]`` the number of earlier rows
    with key ``keys[i]``.

    Rows pad to whole blocks with the reserved bin ``parts``; per-block
    histograms, an exclusive prefix sum over blocks, then each block's
    one-hot cumsum, in blocks of ``RANK_BLK`` rows.  No sort.  The rank does
    not depend on the block size."""
    n = keys.shape[0]
    dev = keys.device
    width = parts + 1                          # + reserved padding bin
    blk = min(RANK_BLK, max(8, (n + 7) // 8 * 8))
    npad = (n + blk - 1) // blk * blk
    k2 = torch.cat([keys.to(torch.int32),
                    torch.full((npad - n,), parts, dtype=torch.int32,
                               device=dev)])
    nb = npad // blk
    hist = radix_hist_ref(k2, width, blk, hashed=False).to(torch.int32)
    base = torch.cumsum(hist, dim=0, dtype=torch.int32) - hist     # (nb, W)
    bins = bin_of(k2, width, False).reshape(nb, blk)
    onehot = (bins[:, :, None] == torch.arange(width, device=dev)) \
        .to(torch.int32)                                           # (nb, blk, W)
    rank = base[:, None, :] + torch.cumsum(onehot, dim=1, dtype=torch.int32) \
        - onehot
    slot = torch.gather(rank, 2, bins[:, :, None]).reshape(npad)
    return slot[:n], hist.sum(dim=0, dtype=torch.int32)[:parts]
