"""Execution backends for tensor query plans (single-device slice).

Queries are written once against the Context API and run on two engines:

  * :class:`RefContext`   — NumPy oracle / CPU baseline (exact shapes), the
    port's own copy of the reference package's.
  * :class:`LocalContext` — one device, PyTorch, static shapes, exchanges
    are identity (counted and logged so plan statistics — paper Table 4 —
    and per-exchange wire bytes come out as on a cluster).

The distributed context, ``partition_database`` and ``run_distributed`` of
``repro.core.backend`` land with the distributed slice; ``PARTITION_KEYS``
is here already because the planner derives placement from it.

``join_method`` selects the join engine: ``"sorted"`` (searchsorted probe) or
``"hash"`` (bucket table probed by the ``hash_probe`` kernel); both give
identical results and share the per-plan build-side cache.

Everything a query computes stays on the device as tensors — counts and the
overflow flag included — until :func:`run_local` reads the result, so a
query waits on the card once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from . import exchange as ex
from . import planner
from . import reference as ref
from . import relational as rel
from . import wire as wi
from .planner import lift_f64
from .table import Database, Table, from_numpy, resolve_device, to_numpy

__all__ = [
    "PlanStats", "RefContext", "LocalContext", "run_reference", "run_local",
    "device_tables", "PARTITION_KEYS",
]

_YEAR_LUT = None


def _year_lut() -> np.ndarray:
    """epoch-day -> calendar year, for days 1970-01-01 .. 2005-12-31."""
    global _YEAR_LUT
    if _YEAR_LUT is None:
        d = np.arange(0, 13150).astype("timedelta64[D]") + \
            np.datetime64("1970-01-01")
        _YEAR_LUT = d.astype("datetime64[Y]").astype(np.int64) + 1970
    return _YEAR_LUT


def _np_dtype(dt) -> np.dtype:
    """numpy dtype of a numpy or torch dtype (the wire log is host math)."""
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


@dataclasses.dataclass
class PlanStats:
    shuffles: int = 0
    broadcasts: int = 0
    final_gathers: int = 0
    allreduces: int = 0
    overflow_checks: int = 0
    log: list = dataclasses.field(default_factory=list)

    def counts(self):
        return {"shuffles": self.shuffles, "broadcasts": self.broadcasts,
                "final_gathers": self.final_gathers,
                "allreduces": self.allreduces}


def _eval_aggs(t, aggs):
    """Materialize callable agg expressions into arrays."""
    return [(name, op, v(t) if callable(v) else v) for name, op, v in aggs]


def _expand_avg(aggs):
    """avg -> (sum, count) pairs + postprocessing recipe."""
    expanded, post = [], []
    for name, op, v in aggs:
        if op == "avg":
            expanded.append((f"__{name}_s", "sum", v))
            expanded.append((f"__{name}_c", "count", None))
            post.append(name)
        else:
            expanded.append((name, op, v))
    return expanded, post


class _BaseContext:
    """Shared bookkeeping + derived helpers.

    ``_join_cache`` is the per-query build-side cache: a (build table, key)
    pair is indexed at most once per plan, however many joins probe it.  It
    holds a strong reference to the build table so ``id()`` keys stay unique
    for the context's (= one plan's) lifetime.
    """

    join_method = "sorted"

    def __init__(self, db: Database, capacity_factor: float = 2.0,
                 wire_format: str | None = None):
        self.db = db
        self.dicts = db.dicts
        self.stats = PlanStats()
        self.capacity_factor = capacity_factor
        self.wire_format = wire_format or wi.wire_default()
        self._join_cache: dict[tuple, tuple] = {}

    @property
    def wire_narrow(self) -> bool:
        return self.wire_format == "narrow"

    def _lookup(self, values: np.ndarray, idx):
        """``values[idx]``: a host lookup table gathered per row."""
        raise NotImplementedError

    def _wire_entry(self, kind: str, t, wire, narrow: bool | None = None,
                    ) -> ex.ExchangeStats:
        """Per-row wire descriptor of an exchange payload, equal to the
        IR-derived static report (``planner.static_wire_stats``)."""
        names = sorted(t) if isinstance(t, dict) else t.names
        dtypes = {n: _np_dtype(t[n].dtype) for n in names}
        if narrow is None:
            narrow = self.wire_narrow
        fmt = wi.plan_wire_format(names, dtypes, bounds=wire, narrow=narrow)
        return ex.ExchangeStats(
            kind=kind, participants=1, message_bytes=0, total_bytes=0,
            collectives=0, row_wire_bytes=fmt.row_wire_bytes,
            row_logical_bytes=fmt.row_logical_bytes,
            wire="narrow" if fmt.narrow else "wide")

    def bucket_cap(self) -> int:
        """Per-bucket capacity of the hash-join table, scaled by the runner's
        capacity factor (the default 2.0 gives 16)."""
        return max(2, int(round(8 * self.capacity_factor)))

    # -- dictionary-encoded string predicates --------------------------------
    def str_lookup(self, col: str, pred: Callable[[np.ndarray], np.ndarray]):
        """Host-evaluated predicate over dictionary -> per-code boolean."""
        return self.db.dict_mask(col, pred)

    def like(self, t, col: str, *substrings: str):
        """col LIKE '%a%b%' -> ordered substring match on the dictionary."""
        def pred(d):
            m = np.ones(len(d), dtype=bool)
            for i, s in enumerate(d):
                pos = 0
                for sub in substrings:
                    j = s.find(sub, pos)
                    if j < 0:
                        m[i] = False
                        break
                    pos = j + len(sub)
            return m
        return self._lookup(self.str_lookup(col, pred), t[col])

    def rename(self, t, mapping: dict):
        if isinstance(t, dict):
            return {mapping.get(k, k): v for k, v in t.items()}
        return t.rename(mapping)

    def starts_with(self, t, col: str, prefix: str):
        lut = self.str_lookup(
            col, lambda d: np.char.startswith(d.astype(str), prefix))
        return self._lookup(lut, t[col])

    def ends_with(self, t, col: str, suffix: str):
        lut = self.str_lookup(
            col, lambda d: np.char.endswith(d.astype(str), suffix))
        return self._lookup(lut, t[col])

    def alpha_rank(self, t, col: str):
        """Alphabetical rank of a dictionary-encoded column (ORDER BY on
        strings: code order != lexicographic order)."""
        d = self.dicts[col]
        rank = np.empty(len(d), dtype=np.int64)
        rank[np.argsort(d)] = np.arange(len(d))
        return self._lookup(rank, t[col])

    def dict_bits(self, col: str) -> int:
        """Provable bit width of a dictionary-encoded column."""
        return max(1, math.ceil(math.log2(max(2, len(self.dicts[col])))))

    def year(self, t_or_col, col: str | None = None):
        """Calendar year of an epoch-days column via a host LUT."""
        v = t_or_col[col] if col is not None else t_or_col
        return self._lookup(_year_lut(), v)

    def isin(self, t, col: str, values: Sequence[str]):
        x = t[col]
        m = x != x                      # all False, on the column's device
        for c in self.db.codes(col, values):
            m = m | (x == c)
        return m

    # -- exchange bookkeeping ------------------------------------------------
    def _count(self, kind: str, stats=None):
        if kind == "shuffle":
            self.stats.shuffles += 1
        elif kind in ("broadcast", "broadcast_p2p"):
            self.stats.broadcasts += 1
        elif kind == "gather":
            self.stats.final_gathers += 1
        elif kind == "allreduce":
            self.stats.allreduces += 1
        if stats is not None:
            self.stats.log.append(stats)


# ===========================================================================
# NumPy reference backend
# ===========================================================================

class RefContext(_BaseContext):
    distributed = False

    def _lookup(self, values: np.ndarray, idx):
        return np.asarray(values)[idx]

    def cast(self, x, dtype: str):
        return np.asarray(x).astype(getattr(np, dtype))

    def where(self, cond, a, b):
        return np.where(cond, a, b)

    def scan(self, name):
        return dict(self.db.tables[name])  # RTable = dict of np arrays

    def filter(self, t, mask):
        return ref.filter_rows(t, np.asarray(mask))

    def with_col(self, t, **exprs):
        out = dict(t)
        for k, fn in exprs.items():
            out[k] = fn(t) if callable(fn) else fn
        return out

    def select(self, t, *names):
        return {n: t[n] for n in names}

    def _key(self, t, on):
        if isinstance(on, str):
            return t[on]
        return ref.combine_keys([t[c] for c in on])

    def join(self, probe, build, probe_on, build_on, take):
        return ref.join_unique(probe, build, self._key(probe, probe_on),
                               self._key(build, build_on), take)

    def semi(self, probe, build, probe_on, build_on):
        return ref.semi_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on))

    def anti(self, probe, build, probe_on, build_on):
        return ref.anti_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on))

    def left(self, probe, build, probe_on, build_on, take, defaults):
        return ref.left_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on), take, defaults)

    def group_by(self, t, keys, aggs, exchange="local", final=False,
                 groups_hint=None, key_bits=None, wire=None, method="auto"):
        # key_bits / method are engine planning hints; the oracle ignores them
        aggs, avg_post = _expand_avg(list(aggs))
        out = ref.group_aggregate(t, keys, _eval_aggs(t, aggs))
        # the exchange (were this distributed) moves the expanded partial
        if exchange == "shuffle":
            self._count("shuffle", self._wire_entry("shuffle", out, wire))
        elif exchange == "gather":
            kind = "gather" if final else "broadcast"
            self._count(kind, self._wire_entry(kind, out, wire))
        for name in avg_post:
            out[name] = out[f"__{name}_s"] / np.maximum(out[f"__{name}_c"], 1)
            del out[f"__{name}_s"], out[f"__{name}_c"]
        return out

    def agg_scalar(self, t, aggs):
        self._count("allreduce")
        aggs, avg_post = _expand_avg(list(aggs))
        g = ref.group_aggregate(t, [], _eval_aggs(t, aggs))
        out = {k: (v[0] if len(v) else np.asarray(0.0)) for k, v in g.items()}
        for name in avg_post:
            out[name] = out[f"__{name}_s"] / max(out[f"__{name}_c"], 1)
            del out[f"__{name}_s"], out[f"__{name}_c"]
        return out

    def shuffle(self, t, key, wire=None):
        self._count("shuffle", self._wire_entry("shuffle", t, wire))
        return t

    def broadcast(self, t, p2p=False, wire=None):
        kind = "broadcast_p2p" if p2p else "broadcast"
        # the p2p variant is the §7.1 baseline and deliberately stays wide
        self._count(kind, self._wire_entry(kind, t, wire,
                                           narrow=False if p2p else None))
        return t

    def shrink(self, t, cap):
        self.stats.overflow_checks += 1
        return t

    def finalize(self, t, sort_keys=None, limit=None, replicated=False,
                 wire=None):
        if not replicated:
            self._count("gather", self._wire_entry("gather", t, wire))
        if sort_keys:
            t = ref.sort_by(t, sort_keys)
        if limit is not None:
            t = ref.limit(t, limit)
        return t

    def nrows(self, t):
        return len(next(iter(t.values())))


# ===========================================================================
# Single-device PyTorch backend (static shapes, exchanges are identity)
# ===========================================================================

class LocalContext(_BaseContext):
    distributed = False

    def __init__(self, db, tables: dict[str, Table], device: torch.device,
                 capacity_factor=2.0, join_method: str = "sorted",
                 wire_format: str | None = None):
        super().__init__(db, capacity_factor, wire_format)
        self._tables = tables
        self.device = torch.device(device)
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self.join_method = join_method

    def _lookup(self, values: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
        """Rows past a table's count may hold any value (a min/max identity,
        say); the reference's gather clamps such an index where torch would
        raise, so indices are clamped into the table — valid rows are always
        in range."""
        lut = torch.from_numpy(np.ascontiguousarray(values)).to(self.device)
        return lut[idx.clamp(0, lut.shape[0] - 1)]

    def cast(self, x, dtype: str):
        return x.to(getattr(torch, dtype))

    def where(self, cond, a, b):
        """``torch.where`` with the reference's float64 promotion: a Python
        float branch makes the result float64 (torch would pick float32)."""
        if isinstance(a, float) or isinstance(b, float):
            a, b = (torch.tensor(x, dtype=torch.float64, device=self.device)
                    if isinstance(x, float) else lift_f64(x) for x in (a, b))
        return torch.where(cond, a, b)

    def scan(self, name):
        return self._tables[name]

    def filter(self, t, mask):
        return rel.filter_rows(t, mask)

    def with_col(self, t, **exprs):
        return t.replace(**{k: (fn(t) if callable(fn) else fn)
                            for k, fn in exprs.items()})

    def select(self, t, *names):
        return t.select(*names)

    def _key(self, t, on):
        if isinstance(on, str):
            return t[on]
        return rel.combine_keys([t[c] for c in on])

    def _build_index(self, build, build_on) -> rel.BuildIndex:
        """Per-plan build cache: index each (build table, key) pair once."""
        if isinstance(build_on, str):
            on_desc = build_on
        elif isinstance(build_on, (list, tuple)) and \
                all(isinstance(c, str) for c in build_on):
            on_desc = tuple(build_on)
        else:  # raw key arrays etc. — build fresh rather than key by id()
            on_desc = None
        ck = (id(build), on_desc)
        hit = self._join_cache.get(ck) if on_desc is not None else None
        if hit is not None:
            return hit[1]
        idx = rel.build_index(build, self._key(build, build_on),
                              method=self.join_method,
                              bucket_cap=self.bucket_cap())
        self.overflow = self.overflow | idx.overflow
        if on_desc is not None:
            self._join_cache[ck] = (build, idx)  # keep build alive: id()
        return idx

    def join(self, probe, build, probe_on, build_on, take):
        return rel.join_unique(probe, build, self._key(probe, probe_on),
                               self._key(build, build_on), take,
                               index=self._build_index(build, build_on))

    def semi(self, probe, build, probe_on, build_on):
        return rel.semi_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on),
                             index=self._build_index(build, build_on))

    def anti(self, probe, build, probe_on, build_on):
        return rel.anti_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on),
                             index=self._build_index(build, build_on))

    def left(self, probe, build, probe_on, build_on, take, defaults):
        return rel.left_join(probe, build, self._key(probe, probe_on),
                             self._key(build, build_on), take, defaults,
                             index=self._build_index(build, build_on))

    def group_by(self, t, keys, aggs, exchange="local", final=False,
                 groups_hint=None, key_bits=None, wire=None, method="auto"):
        """``method`` selects the aggregation path (planner rule: ``hash``
        when ``groups_hint`` is claimed but ``key_bits`` is unprovable); the
        dictionary scales with the runner's capacity factor."""
        aggs, avg_post = _expand_avg(list(aggs))
        out, ov = rel.group_aggregate(t, keys, _eval_aggs(t, aggs),
                                      key_bits=key_bits, method=method,
                                      groups_hint=groups_hint,
                                      hash_factor=self.capacity_factor,
                                      return_overflow=True)
        self.overflow = self.overflow | ov
        if groups_hint is not None:
            out, ov = rel.static_shrink(out, min(out.capacity, groups_hint))
            self.overflow = self.overflow | ov
        # logged after the partial, where the distributed engine exchanges
        if exchange == "shuffle":
            self._count("shuffle", self._wire_entry("shuffle", out, wire))
        elif exchange == "gather":
            kind = "gather" if final else "broadcast"
            self._count(kind, self._wire_entry(kind, out, wire))
        for name in avg_post:
            cnt = torch.clamp(out[f"__{name}_c"], min=1)
            out = out.replace(**{name: lift_f64(out[f"__{name}_s"]) / cnt})
            out = out.drop(f"__{name}_s", f"__{name}_c")
        return out

    def agg_scalar(self, t, aggs):
        self._count("allreduce")
        aggs, avg_post = _expand_avg(list(aggs))
        g = rel.group_aggregate(t, [], _eval_aggs(t, aggs))
        out = {name: g[name][0] for name in g.names}
        for name in avg_post:
            out[name] = lift_f64(out[f"__{name}_s"]) / \
                torch.clamp(out[f"__{name}_c"], min=1)
            del out[f"__{name}_s"], out[f"__{name}_c"]
        return out

    def shuffle(self, t, key, wire=None):
        self._count("shuffle", self._wire_entry("shuffle", t, wire))
        return t

    def broadcast(self, t, p2p=False, wire=None):
        kind = "broadcast_p2p" if p2p else "broadcast"
        self._count(kind, self._wire_entry(kind, t, wire,
                                           narrow=False if p2p else None))
        return t

    def shrink(self, t, cap):
        self.stats.overflow_checks += 1
        t, ov = rel.static_shrink(t, cap)
        self.overflow = self.overflow | ov
        return t

    def finalize(self, t, sort_keys=None, limit=None, replicated=False,
                 wire=None):
        if not replicated:
            self._count("gather", self._wire_entry("gather", t, wire))
        if sort_keys:
            t = rel.sort_by(t, sort_keys)   # sorted output is compact
        else:
            t = rel.ensure_compact(t)       # finalize is a contiguity boundary
        if limit is not None:
            t = rel.limit(t, limit)
        return t

    def nrows(self, t):
        return t.count


# ===========================================================================
# drivers
# ===========================================================================

def run_reference(query_fn, db: Database, wire_format: str | None = None,
                  ) -> tuple[dict, PlanStats]:
    ctx = RefContext(db, wire_format=wire_format)
    out = query_fn(ctx)
    if isinstance(out, dict) and out and \
            np.ndim(next(iter(out.values()))) == 0:
        out = {k: np.asarray([v]) for k, v in out.items()}
    return out, ctx.stats


_DEVICE_TABLES = "_device_tables"


def device_tables(db: Database, device: torch.device) -> dict[str, Table]:
    """``db``'s tables as padded device Tables, uploaded once per device and
    cached on ``db`` (dropped by ``planner.invalidate_stats`` with the
    planner's own caches), so the data stays resident between queries."""
    cache = db.__dict__.setdefault(_DEVICE_TABLES, {})
    key = str(device)
    if key not in cache:
        out = {}
        for name, t in db.tables.items():
            n = len(next(iter(t.values())))
            cap = max(8, int(math.ceil(n / 8)) * 8)
            out[name] = from_numpy(t, capacity=cap, device=device)
        cache[key] = out
    return cache[key]


def _drop_device_tables(db) -> None:
    db.__dict__.pop(_DEVICE_TABLES, None)


planner.register_invalidation(_drop_device_tables)


def _as_column(v, device: torch.device) -> torch.Tensor:
    """A scalar result (0-d tensor or Python number) as a length-1 column;
    Python floats become float64, as under the reference's x64."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1)
    dtype = torch.float64 if isinstance(v, float) else None
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(1)


def run_local(query_fn, db: Database, join_method: str = "sorted",
              capacity_factor: float = 2.0, wire_format: str | None = None,
              return_overflow: bool = False,
              device: str | torch.device | None = None,
              ) -> tuple[dict, PlanStats] | tuple[dict, PlanStats, bool]:
    """Run a query on one device (``cuda`` unless ``device`` names another;
    raises where CUDA is absent).  Returns host numpy columns and the plan
    statistics; a capacity overflow raises unless ``return_overflow``."""
    dev = resolve_device(device)
    ctx = LocalContext(db, device_tables(db, dev), dev,
                       capacity_factor=capacity_factor,
                       join_method=join_method, wire_format=wire_format)
    out = query_fn(ctx)
    if isinstance(out, dict):
        out = Table({k: _as_column(v, dev) for k, v in out.items()},
                    torch.ones((), dtype=torch.int32, device=dev))
    result = to_numpy(rel.ensure_compact(out))
    overflow = bool(ctx.overflow)
    if return_overflow:
        return result, ctx.stats, overflow
    if overflow:
        raise RuntimeError("capacity overflow in local run")
    return result, ctx.stats


# Paper §4.3: lineitem by l_orderkey (co-partitioned with orders), partsupp by
# ps_partkey, others by primary key; nation/region replicated (tiny dims).
PARTITION_KEYS = {
    "lineitem": "l_orderkey",
    "orders": "o_orderkey",
    "partsupp": "ps_partkey",
    "part": "p_partkey",
    "supplier": "s_suppkey",
    "customer": "c_custkey",
    "nation": None,      # replicated
    "region": None,      # replicated
}
