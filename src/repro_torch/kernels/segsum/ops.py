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

import torch

from repro_torch import kernels as K
from .ref import identity, segment_reduce_ref

__all__ = ["segment_reduce", "sum_plan"]

_c = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_SIGNATURES = {
    "segsum_sum": [_i, _i, _c, _c, _ll, _i, _i, _i, _ll, _i, _i, _i, _c, _c,
                   _c],
    "segsum_minmax": [_i, _i, _c, _c, _ll, _i, _i, _i, _c, _c, _c],
}

# launch geometry of csrc/segsum.cu (kPrivateCells, kMaxCols, shared memory)
_SUM_SMEM = 200 * 1024          # shared memory one block may use
_PRIVATE_CELLS = 48
_WARP_COLS = 4
_WARPS_MAX = 8
_ROWS_PER_BLOCK = 8192
_SUM_BLOCKS_MAX = 2048


def sum_plan(n: int, groups: int, ncols: int, itemsize: int, count: bool
             ) -> tuple[int, int, int, int, int]:
    """(nblocks, chunk, group tile, column tile, warps) of one grouped sum.

    A function of the shapes only, so equal inputs reduce in the same order
    and give the same bits on every run.  Up to ``_PRIVATE_CELLS`` cells the
    kernel keeps a partial per thread; above, one per warp, so the column
    tile shrinks until four warps' copies fit in shared memory and the group
    tile until one does.  A block gets at least 8 rows per partial cell."""
    ct = 1 if count else ncols
    if groups * ct <= _PRIVATE_CELLS:
        gt, warps, rows = groups, 4, _ROWS_PER_BLOCK
    else:
        ct = min(ct, _WARP_COLS)
        while ct > 1 and 4 * groups * ct * itemsize > _SUM_SMEM:
            ct -= 1
        gt = min(groups, _SUM_SMEM // (ct * itemsize))
        warps = min(_WARPS_MAX, _SUM_SMEM // (gt * ct * itemsize))
        rows = max(_ROWS_PER_BLOCK, 8 * gt * ct)
    nblocks = max(1, min(_SUM_BLOCKS_MAX, -(-n // rows)))
    return nblocks, -(-n // nblocks), gt, ct, warps


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
    itemsize = torch.empty((), dtype=dtype).element_size()
    nblocks, chunk, gt, ct, warps = sum_plan(n, groups, ncols, itemsize,
                                             count)
    partial = torch.empty(nblocks * gt * ct, dtype=dtype, device=dev)
    out = torch.empty((groups, ncols), dtype=dtype, device=dev)
    lib = K.load("segsum", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.segsum_sum(K.dtype_code(dtype), int(count), K.ptr(gids),
                            K.ptr(vals), n, ncols, groups, nblocks, chunk, gt,
                            ct, warps, K.ptr(partial), K.ptr(out),
                            K.stream_of(gids))
    K.check(lib, rc, "segsum_sum")
    K.count_launch("segsum_sum")
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
