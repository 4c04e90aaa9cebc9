"""Plain PyTorch version of the sortless grouped reductions.

Dtype-preserving scatter-reduce, the counterpart of
``repro.kernels.segsum.ref.segment_reduce_ref``: ids outside ``[0, groups)``
are dropped (the dead-slot convention of ``ops.py``); an empty group holds 0
for sum and the reduction identity for min/max (+inf / -inf, integers the
dtype's max / min), as ``jax.ops.segment_min``/``segment_max`` leave it.
"""
from __future__ import annotations

import torch


def identity(dtype: torch.dtype, op: str):
    """Reduction identity of ``op`` ("min" / "max") for ``dtype``."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce_ref(gids: torch.Tensor, values: torch.Tensor, groups: int,
                       op: str) -> torch.Tensor:
    """(n,) ids, (n, C) values -> (groups, C) sum / min / max."""
    g = gids.to(torch.int64)
    g = torch.where((g < 0) | (g >= groups), groups, g)   # dropped slot
    c = values.shape[1]
    if op == "sum":
        out = torch.zeros((groups + 1, c), dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, g, values)[:groups]
    if op not in ("min", "max"):
        raise ValueError(f"unknown segment reduce op {op!r}")
    out = torch.full((groups + 1, c), identity(values.dtype, op),
                     dtype=values.dtype, device=values.device)
    idx = g[:, None].expand(-1, c)
    return out.scatter_reduce_(0, idx, values, "amin" if op == "min"
                               else "amax")[:groups]
