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

``counting_rank`` goes through the custom op ``repro_torch::counting_rank``,
whose fake implementation gives the shapes alone (slot (n,), counts
(parts,)), so it also runs on ``meta`` tensors.  On a DTensor (the MoE
layer of a sharded model) the rank is global: the keys are replicated and
each rank ranks its whole local copy (``local_map``), which on a CUDA
DTensor launches the kernel on the local tensor.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch import kernels as K
from .ref import counting_rank_ref, radix_hist_plain

__all__ = ["radix_hist", "counting_rank", "skew_stats", "hist_plan",
           "HistPlan", "rank_design", "rank_scratch", "RADIX_HIST_PARTS_MAX",
           "COUNTING_RANK_PARTS_MAX", "ONEPASS_WIDTH_MAX"]

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_SIGNATURES = {"radix_hist": [_c, _ll, _ll, _i, _i, _i, _i, _i, _i, _c, _c],
               "counting_rank": [_c, _ll, _ll, _i, _c, _c, _c, _c],
               "counting_rank_onepass": [_c, _ll, _i, _c, _c, _c, _c]}

# shared memory of csrc/radix_hist.cu: one int per bin in the histogram
# (48 KB), (8 warps + 1) ints per bin in the rank pass
RADIX_HIST_PARTS_MAX = 12288
COUNTING_RANK_PARTS_MAX = 4096
# rows per tile of the three-pass rank: the kernel takes it as an argument,
# and the (tiles, width) scratch is sized from it here
_RANK_TILE = 4096
# the single-pass rank: one lane per bin, so widths up to 32 (the shuffle's
# N + 2 for N <= 30); tiles of 4096 rows (csrc kOnePassTile)
ONEPASS_WIDTH_MAX = 32
_ONEPASS_TILE = 4096


# the histogram's geometry (csrc hist_kernel): at most 8 blocks an SM (its
# launch bounds), on the 132 SMs of an H100 SXM
_HIST_BLOCKS_SM = 8
_SMS = 132
_SMEM_SM = 233_472              # shared memory of one SM, 1 KB a block reserved


class HistPlan(NamedTuple):
    """Geometry of one partition histogram (csrc/radix_hist.cu hist_kernel)."""
    vector: bool      # 16-byte key loads; else lane by lane
    nblocks: int      # the persistent grid
    smem: int         # dynamic shared memory of a block, bytes (the launch's)


def hist_plan(n: int, parts: int, blk: int, aligned: bool = True
              ) -> HistPlan:
    """The histogram of ``n`` keys into ``parts`` bins per block of ``blk``
    rows: one copy of the histogram a block in shared memory (``parts``
    ints).  Keys load 16 bytes at a time where they are 16-byte ``aligned``
    and ``blk % 4 == 0`` (every chunk then starts on a 16-byte boundary),
    else lane by lane.  The grid is persistent: at most 8 blocks an SM,
    fewer where shared memory holds fewer, and no more blocks than
    histogram blocks."""
    if not 1 <= parts <= RADIX_HIST_PARTS_MAX:
        raise ValueError(f"radix_hist: parts must be in [1, "
                         f"{RADIX_HIST_PARTS_MAX}], got {parts}")
    smem = parts * 4
    per_sm = min(_HIST_BLOCKS_SM, _SMEM_SM // (smem + 1024))
    nblocks = max(1, min(-(-n // blk), _SMS * per_sm))
    return HistPlan(aligned and blk % 4 == 0, nblocks, smem)


def _hist(k: torch.Tensor, parts: int, blk: int, hashed: bool,
          out: torch.Tensor) -> None:
    """Launch the histogram of the contiguous int32 keys ``k`` into ``out``
    ((ceil(n / blk), parts), float32 or int32) on ``k``'s stream."""
    n = k.shape[0]
    plan = hist_plan(n, parts, blk, k.data_ptr() % 16 == 0)
    lib = K.load("radix_hist", _SIGNATURES)
    with torch.cuda.device(k.device):
        rc = lib.radix_hist(K.ptr(k), n, blk, parts, int(hashed),
                            int(plan.vector), plan.nblocks, plan.smem,
                            int(out.dtype == torch.int32), K.ptr(out),
                            K.stream_of(k))
    K.check(lib, rc, "radix_hist")


def rank_design(width: int) -> str:
    """The counting-rank kernel of ``width`` bins (parts + 1):
    ``"single_pass"`` (decoupled look-back, one launch) up to
    ``ONEPASS_WIDTH_MAX``, ``"three_pass"`` above."""
    if width < 1:
        raise ValueError(f"counting_rank: width must be >= 1, got {width}")
    return "single_pass" if width <= ONEPASS_WIDTH_MAX else "three_pass"


def rank_scratch(n: int, width: int) -> tuple[int, torch.dtype]:
    """(elements, dtype) of the scratch a counting rank of ``n`` keys into
    ``width`` bins passes its kernel: for the single pass the look-back words
    of each tile and bin plus the tile ticket (int64, zeroed by the kernel's
    own call), for three passes the (tiles, width) int32 tile counts."""
    if rank_design(width) == "single_pass":
        return -(-n // _ONEPASS_TILE) * width + 1, torch.int64
    return -(-n // _RANK_TILE) * width, torch.int32


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
    _hist(k, parts, blk, hashed, out)
    K.count_launch("radix_hist")
    return out


def counting_rank(keys: torch.Tensor, parts: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable counting rank: keys (n,) in [0, parts) -> (slot (n,) int32,
    counts (parts,) int32).  ``slot[i]`` is the number of rows before i with
    the same key; ``counts[p]`` the rows with key p.  No sort on either
    path, and the same slots as a stable sort by key would give.  On a
    DTensor both outputs are replicated DTensors on its mesh."""
    if isinstance(keys, DTensor):
        rep = [Replicate()] * keys.device_mesh.ndim
        return local_map(_counting_rank_op, out_placements=(rep, rep),
                         in_placements=(rep, None),
                         device_mesh=keys.device_mesh,
                         redistribute_inputs=True)(keys, parts)
    return _counting_rank_op(keys, parts)


@torch.library.custom_op("repro_torch::counting_rank", mutates_args=(),
                         schema="(Tensor keys, int parts) -> (Tensor, Tensor)")
def _counting_rank_op(keys: torch.Tensor, parts: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    return _counting_rank(keys, parts)


@_counting_rank_op.register_fake
def _(keys: torch.Tensor, parts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shapes only (a ``meta`` or fake tensor), within the kernel's
    bounds."""
    _check_rank_parts(parts)
    return (keys.new_empty(keys.shape, dtype=torch.int32),
            keys.new_empty((parts,), dtype=torch.int32))


def _check_rank_parts(parts: int) -> None:
    if not 1 <= parts <= COUNTING_RANK_PARTS_MAX:
        raise ValueError(f"counting_rank: parts must be in [1, "
                         f"{COUNTING_RANK_PARTS_MAX}] (shared memory of the "
                         f"rank pass), got {parts}")


def _counting_rank(keys: torch.Tensor, parts: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank on a plain tensor: the plain version on the CPU, the
    kernel on CUDA."""
    if keys.device.type == "cpu":
        return counting_rank_ref(keys, parts)
    _check_rank_parts(parts)
    k = _keys32(keys, "counting_rank")
    n = k.shape[0]
    width = parts + 1                  # the reference's reserved padding bin
    slot = torch.empty(n, dtype=torch.int32, device=k.device)
    if n == 0:
        return slot, torch.zeros(parts, dtype=torch.int32, device=k.device)
    totals = torch.empty(width, dtype=torch.int32, device=k.device)
    size, dtype = rank_scratch(n, width)
    scratch = torch.empty(size, dtype=dtype, device=k.device)
    lib = K.load("radix_hist", _SIGNATURES)
    single = rank_design(width) == "single_pass"
    with torch.cuda.device(k.device):
        if single:
            rc = lib.counting_rank_onepass(K.ptr(k), n, width, K.ptr(scratch),
                                           K.ptr(totals), K.ptr(slot),
                                           K.stream_of(k))
        else:
            # pass 1, the tiles' histograms, is the partition histogram's
            # kernel; passes 2 and 3 scan them and rank
            _hist(k, width, _RANK_TILE, False, scratch.view(-1, width))
            rc = lib.counting_rank(K.ptr(k), n, _RANK_TILE, width,
                                   K.ptr(scratch), K.ptr(totals), K.ptr(slot),
                                   K.stream_of(k))
    K.check(lib, rc, "counting_rank")
    K.count_launch("counting_rank")
    if single:
        K.count_launch("counting_rank_onepass")
    return slot, totals[:parts]


def skew_stats(keys: torch.Tensor, parts: int, **kw) -> dict:
    """Paper §3.5 inputs: per-partition totals + max/mean imbalance."""
    h = radix_hist(keys, parts, **kw)
    tot = h.sum(dim=0)
    mean = torch.clamp(tot.mean(), min=1e-9)
    return {"per_partition": tot, "max": tot.max(),
            "imbalance": tot.max() / mean}
