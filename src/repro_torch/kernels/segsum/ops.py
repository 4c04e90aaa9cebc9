"""Public wrapper of the sortless grouped reductions (sum / count / min / max).

Dead-slot convention, as in the reference: rows the caller wants excluded
(padding, invalid rows, out-of-domain keys) carry the id ``groups``, one past
the real groups, and any id outside ``[0, groups)`` is dropped, so a garbage
id can never scribble into a real group.

On a CPU tensor ``segment_reduce`` runs the plain version
(``ref.segment_reduce_ref``).  On a CUDA tensor it launches
``csrc/segsum.cu`` for int32, int64, float32 and float64 values — the TPU
wrapper sent everything but float32 to jnp because the MXU has no float64;
Hopper has native float64 and int64, so nothing here leaves the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as K
from .ref import identity, segment_reduce_ref

__all__ = ["segment_reduce", "sum_plan", "SumPlan"]

_c = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_SIGNATURES = {
    "segsum_sum": [_i, _i, _i, _c, _c, _ll, _i, _i, _i, _ll, _i, _i, _i, _i,
                   _c, _c, _c],
    "segsum_minmax": [_i, _i, _c, _c, _ll, _i, _i, _i, _c, _c, _c],
}

# launch geometry of csrc/segsum.cu.  A constant, never read from the card:
# the geometry, and with it a float sum's order of additions, follows from
# the shapes alone.
_SMS = 132                      # SMs of an H100 SXM
_SMEM_BLOCK = 232_448           # shared memory one block may use (227 KB)
_SMEM_SM = 233_472              # shared memory of one SM, 1 KB a block reserved
_THREADS_SM = 2048
_ROWS_PER_BLOCK = 8192          # least rows a block takes
# integers (kAtomic): 512 threads, two blocks an SM, 96 KB of copies each
_ATOMIC_THREADS = 512
_ATOMIC_COLS = 4
_ATOMIC_SMEM = 96 * 1024
# floats: per-thread partials (kThread) up to _PRIVATE_CELLS cells, else a
# copy per warp (kWarp)
_PRIVATE_CELLS = 48
_PRIVATE_COLS = 8
_PRIVATE_THREADS = 256
_WARP_COLS = 4
_WARPS_MAX = 8
_TAG_BYTES = 1024 * 4           # a warp's claim words (csrc kTagSlots)
_REGIME = {"atomic": 0, "thread": 1, "warp": 2}


class SumPlan(NamedTuple):
    """Geometry of one grouped sum or count (csrc/segsum.cu)."""
    regime: str       # "atomic" (integers), "thread" or "warp" (floats)
    nblocks: int      # blocks; block b covers rows [b * chunk, (b + 1) * chunk)
    chunk: int
    gt: int           # groups of a tile
    ct: int           # columns of a tile
    warps: int        # float: warps (copies) a block; atomic: shared copies
    smem: int         # dynamic shared memory of a block, bytes (the launch's)
    partial: int      # elements of the float partial (0 for atomic)


def _warp_smem(warps: int, cells: int, itemsize: int) -> int:
    """Shared memory of a "warp" block: the warps' copies (rounded to 16
    bytes) and their claim words."""
    return -(-warps * cells * itemsize // 16) * 16 + warps * _TAG_BYTES


def sum_plan(n: int, groups: int, ncols: int, dtype: torch.dtype,
             count: bool = False) -> SumPlan:
    """The geometry of one grouped sum (``count``: row count) of ``n`` rows
    of ``ncols`` columns of ``dtype`` into ``groups`` groups.

    A function of the shapes alone, so equal float inputs reduce in the same
    order and give the same bits on every run, on any card.  Integers take
    atomics.  Floats: up to ``_PRIVATE_CELLS`` cells a partial per thread;
    above, a copy per warp, the column tile shrinking until four warps'
    copies fit in shared memory and the group tile until one does.  The grid
    is persistent: ``_SMS`` x the blocks an SM holds, each with at least
    ``_ROWS_PER_BLOCK`` rows (and 8 per partial cell)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if count or not dtype.is_floating_point:
        acc = 4 if count or itemsize == 4 else 8
        ct = 1 if count else min(ncols, _ATOMIC_COLS)
        tile = groups * ct * acc
        copies = min(_ATOMIC_THREADS // 32, _ATOMIC_SMEM // max(tile, 1))
        regime, gt, warps, smem, bps = "atomic", groups, copies, copies * tile, 2
        rows = _ROWS_PER_BLOCK
    elif groups * min(ncols, _PRIVATE_COLS) <= _PRIVATE_CELLS:
        ct = min(ncols, _PRIVATE_COLS)
        regime, gt, warps = "thread", groups, _PRIVATE_THREADS // 32
        smem = _PRIVATE_THREADS * ((gt * ct) | 1) * itemsize
        bps = min(_THREADS_SM // _PRIVATE_THREADS, _SMEM_SM // (smem + 1024))
        rows = _ROWS_PER_BLOCK
    else:
        regime = "warp"
        ct = min(ncols, _WARP_COLS)
        while ct > 1 and _warp_smem(4, groups * ct, itemsize) > _SMEM_BLOCK:
            ct -= 1
        gt = min(groups, (_SMEM_BLOCK - _TAG_BYTES - 16) // (ct * itemsize))
        warps = _WARPS_MAX
        while warps > 1 and _warp_smem(warps, gt * ct,
                                       itemsize) > _SMEM_BLOCK:
            warps -= 1
        smem = _warp_smem(warps, gt * ct, itemsize)
        bps = min(_THREADS_SM // (warps * 32), _SMEM_SM // (smem + 1024))
        rows = max(_ROWS_PER_BLOCK, 8 * gt * ct)
    nblocks = max(1, min(_SMS * max(bps, 1), -(-n // rows)))
    chunk = -(-n // nblocks)
    partial = 0 if regime == "atomic" else nblocks * gt * ct
    return SumPlan(regime, nblocks, chunk, gt, ct, warps, smem, partial)


def _ids(gids: torch.Tensor, groups: int) -> torch.Tensor:
    """int32 ids for the kernel; wider ids are routed to the dead slot
    first so narrowing cannot wrap a garbage id into a real group."""
    if gids.dtype != torch.int32:
        gids = torch.where((gids < 0) | (gids > groups), groups, gids) \
            .to(torch.int32)
    return gids.contiguous()


def _sum_kernel(gids: torch.Tensor, values: torch.Tensor | None,
                groups: int) -> torch.Tensor:
    count = values is None
    dev = gids.device
    n = gids.shape[0]
    dtype = torch.int64 if count else values.dtype
    ncols = 1 if count else values.shape[1]
    if n == 0 or groups == 0:
        return torch.zeros((groups, ncols), dtype=dtype, device=dev)
    vals = None if count else values.contiguous()
    plan = sum_plan(n, groups, ncols, dtype, count)
    partial = torch.empty(plan.partial, dtype=dtype, device=dev) \
        if plan.partial else None
    out = torch.empty((groups, ncols), dtype=dtype, device=dev)
    lib = K.load("segsum", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.segsum_sum(K.dtype_code(dtype), int(count),
                            _REGIME[plan.regime], K.ptr(gids), K.ptr(vals), n,
                            ncols, groups, plan.nblocks, plan.chunk, plan.gt,
                            plan.ct, plan.warps, plan.smem, K.ptr(partial),
                            K.ptr(out), K.stream_of(gids))
    K.check(lib, rc, "segsum_sum")
    K.count_launch("segsum_sum")
    if count:
        K.count_launch("segsum_count")
    return out


def _minmax_kernel(gids: torch.Tensor, values: torch.Tensor, groups: int,
                   op: str) -> torch.Tensor:
    dev = gids.device
    n, ncols = values.shape
    vals = values.contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = max(1, min(-(-n // 256), 8 * sms))
    okey = torch.empty(max(groups, 1), dtype=torch.int64, device=dev)
    out = torch.empty((groups, ncols), dtype=values.dtype, device=dev)
    lib = K.load("segsum", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.segsum_minmax(K.dtype_code(values.dtype), int(op == "min"),
                               K.ptr(gids), K.ptr(vals), n, ncols, groups,
                               nblocks, K.ptr(okey), K.ptr(out),
                               K.stream_of(gids))
    K.check(lib, rc, "segsum_minmax")
    K.count_launch("segsum_minmax")
    return out


def segment_reduce(gids: torch.Tensor, values: torch.Tensor | None,
                   groups: int, op: str = "sum") -> torch.Tensor:
    """Sortless grouped reduction: sum / count / min / max, dtype-preserving.

    ``values`` is (n,) or (n, C); the result is (groups,) or (groups, C).
    ``op="count"`` ignores ``values`` and returns int64 row counts.
    """
    if op not in ("sum", "count", "min", "max"):
        raise ValueError(f"unknown segment reduce op {op!r}")
    dev = gids.device
    if op == "count":
        squeeze, v = True, None
    else:
        squeeze = values.ndim == 1
        v = values[:, None] if squeeze else values
        if v.ndim != 2 or v.shape[0] != gids.shape[0]:
            raise ValueError(f"segment_reduce: values {tuple(values.shape)} "
                             f"do not match ids {tuple(gids.shape)}")
    if dev.type == "cpu":
        if v is None:
            v = torch.ones((gids.shape[0], 1), dtype=torch.int64)
        out = segment_reduce_ref(gids, v, groups,
                                 "sum" if op == "count" else op)
    elif dev.type == "cuda":
        if v is not None and v.device != dev:
            raise ValueError("segment_reduce: ids and values on different "
                             "devices")
        g = _ids(gids, groups)
        if op in ("sum", "count"):
            out = _sum_kernel(g, v, groups)
        elif groups == 0 or g.shape[0] == 0:      # nothing to fold
            out = torch.full((groups, v.shape[1]), identity(v.dtype, op),
                             dtype=v.dtype, device=dev)
        else:
            out = _minmax_kernel(g, v, groups, op)
    else:
        raise ValueError(f"segment_reduce: unsupported device {dev}")
    return out[:, 0] if squeeze else out
