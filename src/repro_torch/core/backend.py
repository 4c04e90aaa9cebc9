"""Execution backends for tensor query plans.

Queries are written once against the Context API and run on three engines:

  * :class:`RefContext`   — NumPy oracle / CPU baseline (exact shapes), the
    port's own copy of the reference package's.
  * :class:`LocalContext` — one device, PyTorch, static shapes, exchanges
    are identity (counted and logged so plan statistics — paper Table 4 —
    and per-exchange wire bytes come out as on a cluster).
  * :class:`DistContext`  — one per rank of a rank group
    (:mod:`repro_torch.core.comm`); exchange calls are real collectives
    (the paper's distributed TQP model §2.4: every rank runs the same tensor
    program on its partition; no process coordinates them).

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
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from . import comm
from . import exchange as ex
from . import planner
from . import reference as ref
from . import relational as rel
from . import wire as wi
from .planner import lift_f64
from .table import Database, Table, from_numpy, resolve_device, to_numpy

__all__ = [
    "PlanStats", "RefContext", "LocalContext", "DistContext",
    "run_reference", "run_local", "run_distributed",
    "device_tables", "device_shards", "release_shards", "partition_database",
    "hash_partition_np", "PARTITION_KEYS", "result_table", "derive_database",
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


def _finish_avg(out, avg_post):
    """Each avg of ``avg_post`` as sum / max(count, 1), in float64 for an
    integer sum, in place of its (sum, count) pair.  ``out`` is a Table or
    a dict of torch or numpy values."""
    for name in avg_post:
        s, c = out[f"__{name}_s"], out[f"__{name}_c"]
        if isinstance(s, torch.Tensor):
            v = lift_f64(s) / torch.clamp(c, min=1)
        else:
            v = s / np.maximum(c, 1)
        if isinstance(out, Table):
            out = out.replace(**{name: v}).drop(f"__{name}_s", f"__{name}_c")
        else:
            out[name] = v
            del out[f"__{name}_s"], out[f"__{name}_c"]
    return out


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
        dtypes = {n: wi.np_dtype(t[n].dtype) for n in names}
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

    # -- chaos fault injection ---------------------------------------------
    # a ChaosInjector (repro_torch.distributed.chaos), attached by the run_*
    # drivers; None (the default) makes every cut point a no-op
    chaos = None

    def _chaos_point(self, cut: str, tamperable: bool = False):
        """Named failure-domain cut point (scan / exchange / group_by /
        finalize).  Asks the armed injector for a fault due here this
        attempt: TRANSIENT/DETERMINISTIC faults raise, STRAGGLER sleeps,
        OVERFLOW ORs ``ctx.overflow``, and CORRUPT returns a payload tamper
        callable when the call site can route it into a checksummed
        exchange (``tamperable``) — otherwise it ORs ``ctx.corrupt``
        directly, simulating the detection."""
        if self.chaos is None:
            return None
        return self.chaos.fire(cut, self, tamperable=tamperable)


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
        return _finish_avg(out, avg_post)

    def agg_scalar(self, t, aggs):
        self._count("allreduce")
        aggs, avg_post = _expand_avg(list(aggs))
        g = ref.group_aggregate(t, [], _eval_aggs(t, aggs))
        out = {k: (v[0] if len(v) else np.asarray(0.0)) for k, v in g.items()}
        return _finish_avg(out, avg_post)

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
        self.corrupt = torch.zeros((), dtype=torch.bool, device=self.device)
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
        self._chaos_point("scan")
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
        self._chaos_point("group_by")
        aggs, avg_post = _expand_avg(list(aggs))
        out = self._partial(t, keys, aggs, key_bits, method, groups_hint)
        # logged after the partial, where the distributed engine exchanges
        if exchange == "shuffle":
            self._count("shuffle", self._wire_entry("shuffle", out, wire))
        elif exchange == "gather":
            kind = "gather" if final else "broadcast"
            self._count(kind, self._wire_entry(kind, out, wire))
        return _finish_avg(out, avg_post)

    def _aggregate(self, t, keys, aggs, key_bits, method, groups_hint):
        """``rel.group_aggregate`` of evaluated ``aggs``, its dictionary
        scaled by the capacity factor; a lying hint sets ``overflow``."""
        out, ov = rel.group_aggregate(t, keys, aggs, key_bits=key_bits,
                                      method=method, groups_hint=groups_hint,
                                      hash_factor=self.capacity_factor,
                                      return_overflow=True)
        self.overflow = self.overflow | ov
        return out

    def _partial(self, t, keys, aggs, key_bits, method, groups_hint):
        """The partial aggregate of this rank's rows, shrunk to
        ``groups_hint`` rows before any exchange moves it."""
        out = self._aggregate(t, keys, _eval_aggs(t, aggs), key_bits, method,
                              groups_hint)
        if groups_hint is not None:
            out, ov = rel.static_shrink(out, min(out.capacity, groups_hint))
            self.overflow = self.overflow | ov
        return out

    def _scalar_partials(self, t, aggs) -> dict:
        g = rel.group_aggregate(t, [], _eval_aggs(t, aggs))
        return {name: g[name][0] for name in g.names}

    def agg_scalar(self, t, aggs):
        self._chaos_point("group_by")   # scalar aggregation = group_by domain
        self._count("allreduce")
        aggs, avg_post = _expand_avg(list(aggs))
        return _finish_avg(self._scalar_partials(t, aggs), avg_post)

    def shuffle(self, t, key, wire=None):
        self._chaos_point("exchange")
        self._count("shuffle", self._wire_entry("shuffle", t, wire))
        return t

    def broadcast(self, t, p2p=False, wire=None):
        self._chaos_point("exchange")
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
        self._chaos_point("finalize")
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
# Distributed backend (one context per rank of a rank group)
# ===========================================================================

_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


class DistContext(LocalContext):
    """One rank's engine: exchange calls become collectives over ``group``.

    ``corrupt`` collects the wire checksums' verdicts (a received block that
    fails its integrity word); ``overflow`` as in :class:`LocalContext`,
    plus shuffle buckets past their capacity and narrowed lanes out of
    bounds.  A corrupt fault of an armed ``chaos`` injector flips a bit of
    a checksummed payload where one is in flight (packed exchanges)."""
    distributed = True

    def __init__(self, db, tables: dict[str, Table], device: torch.device,
                 group, capacity_factor=2.0, packed_exchange=True,
                 join_method: str = "sorted", wire_format: str | None = None):
        super().__init__(db, tables, device, capacity_factor, join_method,
                         wire_format)
        self.group = group
        self.N = group.size
        self.packed = packed_exchange

    def _cap_per_dest(self, t: Table) -> int:
        return max(8, math.ceil(t.capacity * self.capacity_factor / self.N))

    # -- exchanges ----------------------------------------------------------
    def shuffle(self, t, key, wire=None):
        tamper = self._chaos_point("exchange", tamperable=self.packed)
        self._count("shuffle")
        keyv = t[key] if isinstance(key, str) else self._key(t, key)
        out, ov, cr, _, stats = ex.shuffle(
            t, keyv, self.group, self._cap_per_dest(t), packed=self.packed,
            wire=wire, narrow=self.wire_narrow, tamper=tamper)
        self.stats.log.append(stats)
        self.overflow = self.overflow | ov
        self.corrupt = self.corrupt | cr
        return out

    def broadcast(self, t, p2p=False, wire=None):
        # the p2p baseline ships unchecked: corrupt faults here are simulated
        tamper = self._chaos_point("exchange",
                                   tamperable=self.packed and not p2p)
        self._count("broadcast_p2p" if p2p else "broadcast")
        if p2p:
            out, stats = ex.broadcast_table_p2p(t, self.group)
        else:
            out, ov, cr, stats = ex.broadcast_table(
                t, self.group, packed=self.packed, wire=wire,
                narrow=self.wire_narrow, tamper=tamper)
            self.overflow = self.overflow | ov
            self.corrupt = self.corrupt | cr
        self.stats.log.append(stats)
        return out

    # -- distributed aggregation --------------------------------------------
    def group_by(self, t, keys, aggs, exchange="local", final=False,
                 groups_hint=None, key_bits=None, wire=None, method="auto"):
        """groups_hint: static bound on distinct groups — shrinks the partial
        aggregate BEFORE the exchange, so it moves O(groups), not O(scan
        capacity).  key_bits / method: the per-rank partial and the
        post-exchange merge run the same sortless path.  wire: provable
        (lo, hi) bounds per partial column for the narrow wire format."""
        tamper = self._chaos_point(
            "group_by", tamperable=self.packed and exchange != "local")
        aggs, avg_post = _expand_avg(list(aggs))
        partial = self._partial(t, keys, aggs, key_bits, method, groups_hint)
        if exchange == "local":
            out = partial
        else:
            merge = [(name, _MERGE[op], name) for name, op, _ in aggs]
            if exchange == "shuffle":
                self._count("shuffle")
                keyv = rel.combine_keys([partial[k] for k in keys],
                                        bits=key_bits) if len(keys) > 1 \
                    else partial[keys[0]]
                moved, ov, cr, _, stats = ex.shuffle(
                    partial, keyv, self.group, self._cap_per_dest(partial),
                    packed=self.packed, wire=wire, narrow=self.wire_narrow,
                    tamper=tamper)
                self.stats.log.append(stats)
            elif exchange == "gather":
                kind = "gather" if final else "broadcast"
                self._count(kind)
                moved, ov, cr, stats = ex.broadcast_table(
                    partial, self.group, packed=self.packed, wire=wire,
                    narrow=self.wire_narrow, tamper=tamper)
                self.stats.log.append(dataclasses.replace(stats, kind=kind))
            else:
                raise ValueError(exchange)
            self.overflow = self.overflow | ov
            self.corrupt = self.corrupt | cr
            # the merge reuses the same provable widths (or the same
            # dictionary bound): sortless on BOTH sides of the exchange
            out = self._aggregate(moved, keys, merge, key_bits, method,
                                  groups_hint)
        return _finish_avg(out, avg_post)

    def agg_scalar(self, t, aggs):
        self._chaos_point("group_by")   # allreduce ships unchecked scalars:
        self._count("allreduce")        # corrupt faults here are simulated
        aggs, avg_post = _expand_avg(list(aggs))
        ops = {name: _MERGE[op] for name, op, _ in aggs}
        out = ex.partial_to_global(self._scalar_partials(t, aggs), ops,
                                   self.group)
        return _finish_avg(out, avg_post)

    def finalize(self, t, sort_keys=None, limit=None, replicated=False,
                 wire=None):
        """Final result collection: local order/limit, gather, global order.

        ``replicated=True`` marks tables already merged on every rank (e.g.
        after group_by(exchange='gather')) — no further collection needed."""
        tamper = self._chaos_point(
            "finalize", tamperable=self.packed and not replicated)
        if not replicated:
            self._count("gather")
            if sort_keys:
                t = rel.sort_by(t, sort_keys)
            if limit is not None:
                t = rel.limit(t, limit)   # local top-k before the gather
            t, ov, cr, stats = ex.broadcast_table(
                t, self.group, packed=self.packed, wire=wire,
                narrow=self.wire_narrow, tamper=tamper)
            self.overflow = self.overflow | ov
            self.corrupt = self.corrupt | cr
            self.stats.log.append(dataclasses.replace(stats, kind="gather"))
        if sort_keys:
            t = rel.sort_by(t, sort_keys)
        else:
            t = rel.ensure_compact(t)
        if limit is not None:
            t = rel.limit(t, limit)
        return t


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
_DEVICE_BASE = "_device_base"


def derive_database(db: Database, tables: dict[str, dict]) -> Database:
    """A sibling of ``db`` holding ``db``'s tables plus ``tables`` (a sample
    rung, say).  Its device tables and shards reuse ``db``'s resident
    tensors for every table the two share, so deriving uploads only the new
    tables; the base is held weakly, so a sibling never keeps it alive."""
    out = Database(tables={**db.tables, **tables}, dicts=db.dicts,
                   scale=db.scale)
    out.__dict__[_DEVICE_BASE] = weakref.ref(db)
    return out


def _split_shared(db: Database):
    """``(base, own)``: the live base ``db`` was derived from (or None) and
    the tables of ``db`` it does not share with that base."""
    ref = db.__dict__.get(_DEVICE_BASE)
    base = ref() if ref is not None else None
    if base is None:
        return None, db.tables
    return base, {name: t for name, t in db.tables.items()
                  if base.tables.get(name) is not t}


def device_tables(db: Database, device: torch.device) -> dict[str, Table]:
    """``db``'s tables as padded device Tables, uploaded once per device and
    cached on ``db`` (dropped by ``planner.invalidate_stats`` with the
    planner's own caches), so the data stays resident between queries.  A
    database made by :func:`derive_database` holds its base's Tables (the
    same objects) beside its own."""
    cache = db.__dict__.setdefault(_DEVICE_TABLES, {})
    key = str(device)
    if key not in cache:
        base, own = _split_shared(db)
        out = {}
        if base is not None:
            shared = device_tables(base, device)
            out = {name: shared[name] for name in db.tables
                   if name not in own}
        for name, t in own.items():
            n = len(next(iter(t.values())))
            cap = max(8, int(math.ceil(n / 8)) * 8)
            out[name] = from_numpy(t, capacity=cap, device=device)
        cache[key] = {name: out[name] for name in db.tables}
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


def result_table(out, device: torch.device) -> Table:
    """A plan's output as a compact Table: a ScalarResult's dict of scalars
    becomes one row."""
    if isinstance(out, dict):
        out = Table({k: _as_column(v, device) for k, v in out.items()},
                    torch.ones((), dtype=torch.int32, device=device))
    return rel.ensure_compact(out)


def run_local(query_fn, db: Database, join_method: str = "sorted",
              capacity_factor: float = 2.0, wire_format: str | None = None,
              chaos=None, return_overflow: bool = False,
              device: str | torch.device | None = None,
              ) -> tuple[dict, PlanStats] | tuple[dict, PlanStats, bool]:
    """Run a query on one device (``cuda`` unless ``device`` names another;
    raises where CUDA is absent).  Returns host numpy columns and the plan
    statistics; a capacity overflow raises unless ``return_overflow``.  An
    armed ``chaos`` injector fires at the plan's cut points; a payload
    integrity failure raises :class:`CorruptPayload`."""
    dev = resolve_device(device)
    ctx = LocalContext(db, device_tables(db, dev), dev,
                       capacity_factor=capacity_factor,
                       join_method=join_method, wire_format=wire_format)
    ctx.chaos = chaos
    result = to_numpy(result_table(query_fn(ctx), dev))
    if bool(ctx.corrupt):
        raise wi.CorruptPayload("local run: payload integrity check failed")
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


# -- host-side partitioning (paper §4.3) ------------------------------------

_C1 = np.uint64(0xFF51AFD7ED558CCD)
_C2 = np.uint64(0xC4CEB9FE1A85EC53)


def hash_partition_np(key: np.ndarray, n: int) -> np.ndarray:
    """splitmix64 finalizer — must match relational.hash_partition_ids."""
    with np.errstate(over="ignore"):
        k = key.astype(np.uint64)
        k = (k ^ (k >> np.uint64(33))) * _C1
        k = (k ^ (k >> np.uint64(33))) * _C2
        k = k ^ (k >> np.uint64(33))
        return (k % np.uint64(n)).astype(np.int32)


def partition_database(db: Database, n: int,
                       partition_keys: dict | None = None, ranks=None,
                       ) -> tuple[dict[str, dict], dict[str, int]]:
    """Host-side partitioning -> per-table (stacked shards dict, per-shard cap).

    Columns come shaped (n*cap,), rank d's rows at ``[d*cap, d*cap +
    count_d)``, and ``__count`` shaped (n,).  Replicated tables (key None)
    appear whole in every shard — the standard treatment for tiny dimension
    tables.  The per-shard capacity is a multiple of 8 over the largest
    shard, as in the reference, so every exchange is sized alike.
    ``ranks`` fills only those ranks' rows (the others stay zero): a process
    of a process group gathers only its own.
    """
    pk = dict(PARTITION_KEYS)
    if partition_keys:
        pk.update(partition_keys)
    out, caps = {}, {}
    for name, t in db.tables.items():
        key = pk.get(name)
        if key is None:
            dest = None
            counts = [len(next(iter(t.values())))] * n
        else:
            dest = hash_partition_np(np.asarray(t[key]), n)
            counts = np.bincount(dest, minlength=n).tolist()
        cap = max(8, int(math.ceil(max(counts) / 8)) * 8)
        cols = {c: np.zeros((n * cap,), dtype=v.dtype) for c, v in t.items()}
        for d in range(n) if ranks is None else ranks:
            m = slice(None) if dest is None else dest == d
            for c, v in t.items():
                cols[c][d * cap: d * cap + counts[d]] = v[m]
        cols["__count"] = np.array(counts, dtype=np.int32)
        out[name] = cols
        caps[name] = cap
    return out, caps


_DEVICE_SHARDS = "_device_shards"


def device_shards(db: Database, device: torch.device, n: int,
                  partition_keys: dict | None = None,
                  ranks=None) -> dict[int, dict[str, Table]]:
    """``db`` partitioned over ``n`` ranks: rank -> its device Tables, for
    the ``ranks`` this process holds (default all).

    Uploaded once per rank and cached on ``db`` per (device, n, partition
    keys); dropped by ``planner.invalidate_stats`` with the planner's own
    caches.  A database made by :func:`derive_database` partitions only its
    own tables and holds its base's shards beside them."""
    cache = db.__dict__.setdefault(_DEVICE_SHARDS, {})
    key = (str(device), n, tuple(sorted((partition_keys or {}).items())))
    held = cache.setdefault(key, {})
    todo = [d for d in (range(n) if ranks is None else ranks)
            if d not in held]
    if todo:
        base, own = _split_shared(db)
        shared = device_shards(base, device, n, partition_keys, todo) \
            if base is not None else {}
        sharded, caps = partition_database(
            Database(own, db.dicts, db.scale), n, partition_keys, todo)
        for d in todo:
            mine = {}
            for name, cols in sharded.items():
                lo, hi = d * caps[name], (d + 1) * caps[name]
                mine[name] = Table(
                    {c: torch.from_numpy(v[lo:hi]).to(device)
                     for c, v in cols.items() if c != "__count"},
                    torch.tensor(int(cols["__count"][d]), dtype=torch.int32,
                                 device=device))
            held[d] = {name: mine[name] if name in mine else shared[d][name]
                       for name in db.tables}
    return held


def release_shards(db: Database, device: torch.device, n: int) -> None:
    """Drop ``db``'s cached partitionings over ``n`` ranks on ``device``
    (after a device loss the old width's shards are dead memory)."""
    cache = db.__dict__.get(_DEVICE_SHARDS, {})
    for key in [k for k in cache if k[:2] == (str(device), n)]:
        del cache[key]


def _drop_device_shards(db) -> None:
    db.__dict__.pop(_DEVICE_SHARDS, None)


planner.register_invalidation(_drop_device_shards)


def _warm_planner(query_fn, db: Database) -> None:
    """Fill the planner's caches on ``db`` (column statistics, the plan and
    its PlanInfo) on the calling thread, before any rank starts: the ranks
    then only read them, and all of them run one plan object."""
    planner.column_stats(db)
    q = getattr(query_fn, "_query", query_fn)
    if hasattr(q, "info"):
        q.info(db)


def run_distributed(query_fn, db: Database, group_or_n,
                    capacity_factor: float = 2.0,
                    packed_exchange: bool = True,
                    partition_keys: dict | None = None,
                    join_method: str = "sorted",
                    wire_format: str | None = None,
                    chaos=None,
                    device: str | torch.device | None = None,
                    ) -> tuple[dict, PlanStats, bool]:
    """Run a query on every rank of a group; returns (result, stats,
    overflow).

    ``group_or_n`` is a rank group (:mod:`repro_torch.core.comm`) or a rank
    count N, which means a ``ThreadGroup`` of N ranks on ``device`` (``cuda``
    unless the caller names another; raises where CUDA is absent).  Every
    rank runs the same tensor program on its partition of ``db`` — the
    paper's MPI model.  The result is rank 0's for a ThreadGroup and this
    process's own for a TorchDistGroup (every rank ends with the same
    table).  ``overflow`` is True if any rank overflowed.  A payload that
    failed its integrity check on any rank (possibly through an armed
    ``chaos`` injector's tamper, which every rank's context carries) raises
    :class:`CorruptPayload`: corrupted buffers are never decoded into served
    results.
    """
    if isinstance(group_or_n, int):
        group = comm.ThreadGroup(group_or_n, device)
    else:
        group = group_or_n
    dev = group.device
    shards = device_shards(db, dev, group.size, partition_keys, group.ranks)
    _warm_planner(query_fn, db)

    def rank_body(g):
        ctx = DistContext(db, shards[g.rank], dev, g,
                          capacity_factor=capacity_factor,
                          packed_exchange=packed_exchange,
                          join_method=join_method, wire_format=wire_format)
        ctx.chaos = chaos
        out = result_table(query_fn(ctx), dev)
        flags = g.all_reduce(torch.stack([ctx.overflow, ctx.corrupt])
                             .to(torch.int32), "max")
        return to_numpy(out), ctx.stats, flags.tolist()

    result, stats, (overflow, corrupt) = group.run(rank_body)[0]
    if corrupt:
        raise wi.CorruptPayload(
            "distributed run: payload integrity check failed")
    return result, stats, bool(overflow)
