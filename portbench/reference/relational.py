"""Plain PyTorch relational primitives of the benchmark's reference.

Exact-size columns (no padding, no masks), whole-table operations: boolean
selection, ``torch.isin`` for semi and anti joins, a sorted search for
unique-key joins, ``torch.unique`` for group-bys and stable sorts for ORDER
BY.  They run on the CPU or the card alike.  Nothing here imports the
program: the point of the reference is that it shares no code with what it
judges.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..data.tpch import days

Cols = dict  # column name -> 1-D tensor, all of one length

_FEW_GROUPS = 256


class RefDB:
    """The generated tables as tensors on ``device``, float columns in
    ``fdt`` (the precision the reference computes in), beside the host
    dictionaries and the scale factor."""

    def __init__(self, tables: dict, dicts: dict, scale: float,
                 device: str | torch.device, fdt: torch.dtype):
        self.device = torch.device(device)
        self.fdt = fdt
        self.scale = float(scale)
        self.dicts = dicts
        self._host = tables
        self._dev: dict[str, Cols] = {}

    def table(self, name: str) -> Cols:
        """A table's columns on the device, uploaded at first use."""
        got = self._dev.get(name)
        if got is None:
            got = {}
            for c, v in self._host[name].items():
                t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                got[c] = t.to(self.fdt) if t.is_floating_point() else t
            self._dev[name] = got
        return got

    def code(self, col: str, value: str) -> int:
        idx = np.nonzero(self.dicts[col] == value)[0]
        if idx.size == 0:
            raise KeyError(f"{value!r} not in the dictionary of {col!r}")
        return int(idx[0])

    def dict_lut(self, col: str, pred: Callable[[str], bool]) -> torch.Tensor:
        """A per-code boolean of a predicate over ``col``'s dictionary."""
        m = np.array([bool(pred(str(s))) for s in self.dicts[col]])
        return torch.from_numpy(m).to(self.device)

    def rank(self, col: str) -> torch.Tensor:
        """Alphabetical rank of each code of ``col``'s dictionary."""
        d = self.dicts[col]
        r = np.empty(len(d), dtype=np.int64)
        r[np.argsort(d, kind="stable")] = np.arange(len(d))
        return torch.from_numpy(r).to(self.device)


def like(*subs: str) -> Callable[[str], bool]:
    """``LIKE '%a%b%'``: the substrings in this order."""
    def pred(s: str) -> bool:
        pos = 0
        for sub in subs:
            j = s.find(sub, pos)
            if j < 0:
                return False
            pos = j + len(sub)
        return True
    return pred


def select(t: Cols, rows: torch.Tensor) -> Cols:
    """Rows of ``t`` by a boolean mask or an index."""
    return {k: v[rows] for k, v in t.items()}


def join(probe: torch.Tensor, build: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inner join on a unique build key: ``(hit, at)``, where ``hit``
    marks the probe rows with a match and ``at`` gives each such row's
    build row."""
    if build.numel() == 0:
        return (torch.zeros_like(probe, dtype=torch.bool),
                torch.zeros(0, dtype=torch.int64, device=probe.device))
    order = torch.argsort(build, stable=True)
    keys = build[order]
    if keys.numel() > 1 and bool((keys[1:] == keys[:-1]).any()):
        raise ValueError("join: build keys are not unique")
    pos = torch.searchsorted(keys, probe).clamp_(max=keys.numel() - 1)
    hit = keys[pos] == probe
    return hit, order[pos[hit]]


def lookup(probe: torch.Tensor, build: torch.Tensor, t: Cols,
           take: Sequence[str]) -> tuple[torch.Tensor, Cols]:
    """``join`` and the build table's ``take`` columns of each hit."""
    hit, at = join(probe, build)
    return hit, {c: t[c][at] for c in take}


def pack(*keys: torch.Tensor) -> torch.Tensor:
    """One int64 key from non-negative integer keys, each given the room
    its own largest value needs (no collisions)."""
    out = keys[0].to(torch.int64)
    for k in keys[1:]:
        k = k.to(torch.int64)
        width = int(k.max()) + 1 if k.numel() else 1
        out = out * width + k
    return out


def group(*keys: torch.Tensor) -> tuple[torch.Tensor, int, list]:
    """Group rows by the tuple of ``keys``: ``(inv, groups, key_values)``,
    groups numbered in ascending order of the packed key."""
    if not keys:
        raise ValueError("group: no keys")
    packed = pack(*[k - k.min() if k.numel() else k for k in keys])
    uniq, inv = torch.unique(packed, sorted=True, return_inverse=True)
    g = uniq.numel()
    vals = [torch.zeros(g, dtype=k.dtype, device=k.device).scatter_(0, inv, k)
            for k in keys]
    return inv, g, vals


def gsum(inv: torch.Tensor, g: int, v: torch.Tensor) -> torch.Tensor:
    """Per-group sums.  A float sum of few groups is taken group by group
    as one whole reduction (a tree), so that no group's sum runs through
    millions of additions one after another, as ``index_add_`` would on
    the card; many groups are small, and go through ``index_add_``."""
    if v.is_floating_point() and g <= _FEW_GROUPS:
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        return torch.stack([torch.where(inv == i, v, zero).sum()
                            for i in range(g)]) if g else zero.reshape(0)
    return torch.zeros(g, dtype=v.dtype, device=v.device).index_add_(0, inv, v)


def gcount(inv: torch.Tensor, g: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=g).to(torch.int64)


def gmin(inv: torch.Tensor, g: int, v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(g, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, inv, v, "amin", include_self=False)


def order(t: Cols, keys: Sequence[tuple[str, bool]],
          limit: int | None = None) -> Cols:
    """Rows of ``t`` sorted by ``keys`` ((column, ascending) pairs, the
    first the most significant), stably, then the first ``limit``."""
    n = next(iter(t.values())).shape[0]
    dev = next(iter(t.values())).device
    perm = torch.arange(n, device=dev)
    for c, asc in reversed(list(keys)):
        step = torch.sort(t[c][perm], stable=True, descending=not asc).indices
        perm = perm[step]
    if limit is not None:
        perm = perm[:limit]
    return select(t, perm)


def year_of(d: torch.Tensor) -> torch.Tensor:
    """Calendar year of epoch days."""
    starts = torch.tensor([days(f"{y}-01-01") for y in range(1900, 2101)],
                          dtype=torch.int64, device=d.device)
    return 1900 + torch.searchsorted(starts, d.to(torch.int64),
                                     right=True) - 1


def scalar(**vals: torch.Tensor) -> Cols:
    """A one-row result."""
    return {k: v.reshape(1) for k, v in vals.items()}
