"""Public wrappers: partition histograms, skew statistics and the counting
rank (the sortless shuffle-dispatch primitive).

On a CPU tensor each wrapper runs its plain version (``ref.py``); on a CUDA
tensor it launches ``csrc/radix_hist.cu`` or raises.  The contracts are
those of ``repro.kernels.radix_hist.ops``:

  * ``radix_hist``    (ceil(n / blk), parts) float32 per-block histograms;
  * ``counting_rank`` slot (n,) int32, the number of earlier rows with the
                      same key (the position a stable sort on the key gives
                      a row within its key group), and counts (parts,) int32;
  * ``skew_stats``    per-partition totals and the max / mean imbalance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from .ref import counting_rank_ref, radix_hist_plain

__all__ = ["radix_hist", "counting_rank", "skew_stats",
           "RADIX_HIST_PARTS_MAX", "COUNTING_RANK_PARTS_MAX"]

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_SIGNATURES = {"radix_hist": [_c, _ll, _ll, _i, _i, _c, _c],
               "counting_rank": [_c, _ll, _ll, _i, _c, _c, _c, _c]}

# shared memory of csrc/radix_hist.cu: one int per bin in the histogram
# (48 KB), (8 warps + 1) ints per bin in the rank pass
RADIX_HIST_PARTS_MAX = 12288
COUNTING_RANK_PARTS_MAX = 4096
# rows per counting-rank tile: the kernel takes it as an argument, and the
# (tiles, width) scratch is sized from it here
_RANK_TILE = 4096


def _keys32(keys: torch.Tensor, what: str) -> torch.Tensor:
    if keys.ndim != 1:
        raise ValueError(f"{what}: keys must be 1-D")
    if keys.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {keys.device}")
    return keys.to(torch.int32).contiguous()


def radix_hist(keys: torch.Tensor, parts: int, blk: int = 2048,
               hashed: bool = True) -> torch.Tensor:
    """Per-block partition histograms (ceil(n / blk), parts) float32.

    ``hashed`` bins by ``murmur32(key) % parts``, else by ``key % parts``
    (keys taken as uint32).  Like the reference, the last block counts only
    the real rows (the kernel masks the rows past n; the plain version pads
    with the first key and subtracts the pad)."""
    n = keys.shape[0]
    blk = min(blk, max(8, (n + 7) // 8 * 8))
    if keys.device.type == "cpu":
        return radix_hist_plain(keys, parts, blk, hashed=hashed)
    if not 1 <= parts <= RADIX_HIST_PARTS_MAX:
        raise ValueError(f"radix_hist: parts must be in [1, "
                         f"{RADIX_HIST_PARTS_MAX}], got {parts}")
    k = _keys32(keys, "radix_hist")
    out = torch.empty(((n + blk - 1) // blk, parts), dtype=torch.float32,
                      device=k.device)
    if n == 0:
        return out
    lib = K.load("radix_hist", _SIGNATURES)
    with torch.cuda.device(k.device):
        rc = lib.radix_hist(K.ptr(k), n, blk, parts, int(hashed), K.ptr(out),
                            K.stream_of(k))
    K.check(lib, rc, "radix_hist")
    K.count_launch("radix_hist")
    return out


def counting_rank(keys: torch.Tensor, parts: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable counting rank: keys (n,) in [0, parts) -> (slot (n,) int32,
    counts (parts,) int32).  ``slot[i]`` is the number of rows before i with
    the same key; ``counts[p]`` the rows with key p.  No sort on either
    path, and the same slots as a stable sort by key would give."""
    if keys.device.type == "cpu":
        return counting_rank_ref(keys, parts)
    if not 1 <= parts <= COUNTING_RANK_PARTS_MAX:
        raise ValueError(f"counting_rank: parts must be in [1, "
                         f"{COUNTING_RANK_PARTS_MAX}] (shared memory of the "
                         f"rank pass), got {parts}")
    k = _keys32(keys, "counting_rank")
    n = k.shape[0]
    width = parts + 1                  # the reference's reserved padding bin
    slot = torch.empty(n, dtype=torch.int32, device=k.device)
    totals = torch.zeros(width, dtype=torch.int32, device=k.device)
    if n == 0:
        return slot, totals[:parts]
    tiles = (n + _RANK_TILE - 1) // _RANK_TILE
    scratch = torch.empty((tiles, width), dtype=torch.int32, device=k.device)
    lib = K.load("radix_hist", _SIGNATURES)
    with torch.cuda.device(k.device):
        rc = lib.counting_rank(K.ptr(k), n, _RANK_TILE, width, K.ptr(scratch),
                               K.ptr(totals), K.ptr(slot), K.stream_of(k))
    K.check(lib, rc, "counting_rank")
    K.count_launch("counting_rank")
    return slot, totals[:parts]


def skew_stats(keys: torch.Tensor, parts: int, **kw) -> dict:
    """Paper §3.5 inputs: per-partition totals + max/mean imbalance."""
    h = radix_hist(keys, parts, **kw)
    tot = h.sum(dim=0)
    mean = torch.clamp(tot.mean(), min=1e-9)
    return {"per_partition": tot, "max": tot.max(),
            "imbalance": tot.max() / mean}
