"""Columnar tables with static row capacity — the tensor-format data model.

A :class:`Table` is a dict of equal-length 1-D column tensors on one device,
plus a valid-row ``count`` (a 0-d int32 tensor on the same device, so no
operator has to wait for the card to learn it) and an optional ``valid``
mask.  It replaces the JAX pytree of ``repro.core.table``; the two validity
representations are the same:

  * **compact** (``valid is None``): rows ``[0, count)`` are valid, rows
    beyond are padding;
  * **masked** (``valid`` is a bool column): row ``i`` is valid iff
    ``valid[i]`` and ``count == valid.sum()`` — deferred compaction, so
    filters and joins cost O(n) and the front-compaction runs only at the
    boundaries that need contiguity (``finalize``, capacity shrink,
    ``limit``).

String columns are dictionary-encoded int32 codes; the dictionaries live on
the host in the :class:`Database`, which holds numpy columns exactly like the
reference package's.  :func:`database_from` carries a reference database
across (the tests feed both engines the same data through it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch import tracing

__all__ = [
    "Table",
    "Database",
    "database_from",
    "from_numpy",
    "to_numpy",
    "days",
    "add_months",
    "resolve_device",
    "KEY_SENTINEL",
]

# Sentinel pushed to the back by sorts; larger than any TPC-H key.
KEY_SENTINEL = np.iinfo(np.int64).max


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Asking for CUDA on a machine without it raises — the engine
    never slips onto the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: CUDA is not available; pass "
                           "device='cpu' to run the plain PyTorch versions")
    return dev


@dataclasses.dataclass
class Table:
    """Dict of 1-D columns (same length = capacity) + valid count/mask."""

    columns: dict[str, torch.Tensor]
    count: torch.Tensor            # 0-d int32 on the columns' device
    valid: torch.Tensor | None = None  # bool (capacity,) or None = compact

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.count.device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self.columns))

    def valid_mask(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        return torch.arange(self.capacity, device=self.device) < self.count

    def replace(self, **cols: torch.Tensor) -> "Table":
        new = dict(self.columns)
        new.update(cols)
        return Table(new, self.count, self.valid)

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.count,
                     self.valid)

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self.columns.items()
                      if k not in names}, self.count, self.valid)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()},
                     self.count, self.valid)


@dataclasses.dataclass
class Database:
    """Host-side container: named numpy tables + string dictionaries + scale.

    ``dicts[col]`` is a numpy array of strings such that code ``i`` in column
    ``col`` decodes to ``dicts[col][i]``.
    """

    tables: dict[str, dict[str, np.ndarray]]
    dicts: dict[str, np.ndarray]
    scale: float = 0.0

    def dict_mask(self, col: str,
                  pred: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Evaluate a host-side predicate over the dictionary of ``col`` (how
        LIKE / IN run over dictionary-encoded strings: once over the small
        dictionary, then as a per-row lookup)."""
        return np.asarray(pred(self.dicts[col]))

    def code(self, col: str, value: str) -> int:
        """Dictionary code of an exact string value (host-side)."""
        d = self.dicts[col]
        idx = np.nonzero(d == value)[0]
        if idx.size == 0:
            raise KeyError(f"{value!r} not in dictionary for {col!r}")
        return int(idx[0])

    def codes(self, col: str, values) -> list[int]:
        return [self.code(col, v) for v in values]


def database_from(other) -> Database:
    """A port :class:`Database` holding the same numpy columns, dictionaries
    and scale as ``other`` — any object with ``tables`` (name -> column name
    -> array), ``dicts`` and ``scale`` attributes, such as a database of the
    reference package.  Arrays are shared, not copied; planner caches are
    not carried over."""
    tables = {name: {c: np.asarray(v) for c, v in cols.items()}
              for name, cols in other.tables.items()}
    return Database(tables, dict(other.dicts), float(other.scale))


_EPOCH = np.datetime64("1970-01-01")


def days(date_str: str) -> int:
    """Date literal -> epoch days (host-side; interval math is plain ints)."""
    return int((np.datetime64(date_str) - _EPOCH)
               .astype("timedelta64[D]").astype(np.int64))


def add_months(date_str: str, months: int) -> int:
    d = np.datetime64(date_str, "M") + np.timedelta64(months, "M")
    # preserve day-of-month where TPC-H literals are always day 1 of a month
    day = int(date_str.split("-")[2])
    return days(str(d) + f"-{day:02d}")


def from_numpy(cols: Mapping[str, np.ndarray], capacity: int | None = None,
               device: str | torch.device | None = None) -> Table:
    """Host numpy columns -> padded Table on ``device`` (zero padding);
    ``cuda`` unless the caller names another device."""
    dev = resolve_device(device)
    n = len(next(iter(cols.values())))
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < rows {n}")
    out = {}
    for k, v in cols.items():
        v = np.ascontiguousarray(v)
        col = torch.zeros((cap,) + v.shape[1:],
                          dtype=torch.from_numpy(v[:0]).dtype, device=dev)
        col[:n] = torch.from_numpy(v).to(dev)
        out[k] = col
    return Table(out, torch.tensor(n, dtype=torch.int32, device=dev))


def to_numpy(t: Table) -> dict[str, np.ndarray]:
    """Table -> exact-size host columns (drops padding, keeps row order)."""
    if t.valid is not None:
        m = _host(t.valid)
        return {k: _host(v)[m] for k, v in t.columns.items()}
    with tracing.sync("fetch"):
        n = int(t.count)
    return {k: _host(v[:n]) for k, v in t.columns.items()}


def _host(v: torch.Tensor) -> np.ndarray:
    if not v.numel():           # copying nothing waits on nothing
        return v.cpu().numpy()
    with tracing.sync("fetch"):
        return v.cpu().numpy()
