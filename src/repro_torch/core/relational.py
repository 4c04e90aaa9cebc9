"""Static-shape relational operators in PyTorch (the per-device compute layer).

The counterpart of ``repro.core.relational``, operator for operator and
byte for byte in what a caller can observe (valid rows, their order, counts,
overflow flags):

  * filter        = O(n) validity-mask merge (deferred compaction, no sort)
  * hash join     = sorted-build ``searchsorted`` probe, or the bucket-table
                    probe kernel (``kernels/hash_probe``); build sides are
                    indexed once per plan via :class:`BuildIndex`
  * group-by      = sortless when the key domain is provably small (dense
                    group ids into the ``kernels/segsum`` reduction) or a
                    group bound is claimed (``kernels/hash_group``
                    dictionary); otherwise ONE stable argsort over a packed
                    int64 key, its order reused for every aggregate
  * order-by      = one stable lexicographic sort over all keys with validity
                    sentinels, written as successive stable argsorts (least
                    significant key first) since torch has no multi-operand
                    sort

Every operator takes compact or masked tables and keeps
``count == valid_mask().sum()``.  Counts and flags stay 0-d tensors on the
table's device, so a query runs without waiting on the card until its result
is read.  Scatters whose reference form drops out-of-range indices
(``.at[idx].set(mode="drop")``) write to one extra slot that is then cut
off, because torch raises on an out-of-range index.

Where the reference sorts with ``jnp.argsort`` (stable by default) the port
passes ``stable=True``: unstable torch sorts would reorder equal keys.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .table import KEY_SENTINEL, Table
from repro_torch.kernels.hash_group import ops as _hg_ops
from repro_torch.kernels.hash_probe import ops as _hp_ops
from repro_torch.kernels.segsum import ops as _ss_ops

# The planner reads both ceilings to choose a path, so the port must make the
# reference's choices even though their VMEM rationale does not apply here.
DIRECT_AGG_BITS_MAX = 13
HASH_AGG_GROUPS_MAX = 4096

__all__ = [
    "compact",
    "ensure_compact",
    "filter_rows",
    "combine_keys",
    "BuildIndex",
    "build_index",
    "probe_index",
    "join_unique",
    "semi_join",
    "anti_join",
    "left_join",
    "group_aggregate",
    "sort_by",
    "limit",
    "static_shrink",
    "hash_partition_ids",
]

_I64 = torch.int64
_I32 = torch.int32
# splitmix64 finalizer constants as the int64 values of their uint64 bits
_HASH_C1 = 0xFF51AFD7ED558CCD - (1 << 64)
_HASH_C2 = 0xC4CEB9FE1A85EC53 - (1 << 64)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(_I32)


def _drop_scatter(idx: torch.Tensor, vals: torch.Tensor, size: int,
                  fill=0) -> torch.Tensor:
    """``full((size, ...), fill).at[idx].set(vals, mode="drop")`` for
    indices in ``[0, size]``: index ``size`` lands in an extra row that is
    cut off.  ``vals`` is (n,) or (n, ...) rows."""
    out = torch.full((size + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out[:size]


# ---------------------------------------------------------------------------
# compaction / filtering
# ---------------------------------------------------------------------------

def compact(t: Table, keep: torch.Tensor) -> Table:
    """Move rows where ``keep & valid`` to the front; count = how many.

    The reference does this with a stable argsort of ``~keep``; the same
    permutation comes from two prefix sums (kept rows in order, then the
    rest in order), so this is O(n) and sort-free with identical rows."""
    keep = keep & t.valid_mask()
    nkeep = keep.sum()
    pos = torch.where(keep, torch.cumsum(keep, 0) - 1,
                      nkeep + torch.cumsum(~keep, 0) - 1)
    cols = {}
    for k, v in t.columns.items():
        out = torch.empty_like(v)
        out[pos] = v
        cols[k] = out
    return Table(cols, nkeep.to(_I32))


def ensure_compact(t: Table) -> Table:
    """Materialize the front-compaction of a masked table (no-op if compact)."""
    if t.valid is None:
        return t
    return compact(t, t.valid)


def filter_rows(t: Table, mask: torch.Tensor) -> Table:
    """O(n) filter: merge ``mask`` into the validity mask — no sort."""
    keep = mask & t.valid_mask()
    return Table(dict(t.columns), _count(keep), keep)


def limit(t: Table, n: int) -> Table:
    """First n valid rows (callers sort first).  Statically shrinks capacity."""
    t = ensure_compact(t)
    cols = {k: v[:n] for k, v in t.columns.items()}
    return Table(cols, torch.clamp(t.count, max=n).to(_I32))


def static_shrink(t: Table, new_capacity: int) -> tuple[Table, torch.Tensor]:
    """Shrink capacity (planner's selectivity hint).  Returns (table,
    overflowed): overflow (count > new_capacity) asks the runner to retry
    with a larger capacity."""
    t = ensure_compact(t)
    overflow = t.count > new_capacity
    cols = {k: v[:new_capacity] for k, v in t.columns.items()}
    return Table(cols, torch.clamp(t.count, max=new_capacity).to(_I32)), \
        overflow


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def combine_keys(cols: Sequence[torch.Tensor],
                 bits: Sequence[int] | None = None) -> torch.Tensor:
    """Pack non-negative int key columns into one int64 key.

    Without ``bits``: at most two columns (< 2^31 each) packed with 32-bit
    shifts.  With ``bits``: any number of columns, ``bits[i]`` the provable
    width of column i, ``sum(bits) <= 63``."""
    if bits is not None:
        if len(bits) != len(cols):
            raise ValueError("combine_keys: len(bits) != len(cols)")
        if sum(bits) > 63:
            raise ValueError(f"combine_keys: {sum(bits)} key bits > 63")
        k = torch.zeros(cols[0].shape, dtype=_I64, device=cols[0].device)
        for c, b in zip(cols, bits):
            k = (k << b) | c.to(_I64)
        return k
    if len(cols) > 2:
        raise ValueError("pack >2 keys explicitly in the plan (collision safety)")
    k = cols[0].to(_I64)
    for c in cols[1:]:
        k = (k << 32) | c.to(_I64)
    return k


def _valid_key(t: Table, key: torch.Tensor) -> torch.Tensor:
    """Key column with invalid rows forced to the +inf sentinel."""
    return torch.where(t.valid_mask(), key.to(_I64), KEY_SENTINEL)


def _shr64(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (uint64 ``>>``, absent on CPU)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def hash_partition_ids(key: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Fingerprint-based destination ids for shuffle (splitmix64 finalizer).

    torch on the CPU has no uint64 ``>>`` or ``%``: the finalizer runs on the
    int64 bits (products wrap modulo 2^64 exactly as uint64 ones do) and the
    unsigned remainder is taken from the two 32-bit halves."""
    k = key.to(_I64)
    k = (k ^ _shr64(k, 33)) * _HASH_C1
    k = (k ^ _shr64(k, 33)) * _HASH_C2
    k = k ^ _shr64(k, 33)
    p = num_partitions
    hi, lo = _shr64(k, 32), k & 0xFFFFFFFF
    return ((((hi % p) << 32) | lo) % p).to(_I32)


# ---------------------------------------------------------------------------
# joins (unique build side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuildIndex:
    """Reusable probe structure over a unique-key build side, built once per
    (build table, key) pair and cached per plan by the backend.

      * ``sorted``: keys sorted once, probes are ``searchsorted``.
      * ``hash``: bucket table (a 32-byte head per bucket with its first
        two keys, and the ``tails`` entries of the rest) probed by the
        ``kernels/hash_probe`` kernel — fixed probe length, no log factor.
    """

    method: str
    capacity: int
    overflow: torch.Tensor
    sorted_keys: torch.Tensor | None = None
    sorted_rows: torch.Tensor | None = None
    heads: torch.Tensor | None = None
    tails: torch.Tensor | None = None


def build_index(build: Table, build_key: torch.Tensor, method: str = "sorted",
                bucket_cap: int = 16) -> BuildIndex:
    """Index the build side of a unique-key join (one argsort either way)."""
    bkey = _valid_key(build, build_key)
    no = torch.zeros((), dtype=torch.bool, device=bkey.device)
    if method == "sorted":
        order = torch.argsort(bkey, stable=True)
        return BuildIndex("sorted", build.capacity, no,
                          sorted_keys=bkey[order].contiguous(),
                          sorted_rows=order)
    if method != "hash":
        raise ValueError(f"unknown join method {method!r}")
    rows = torch.arange(build.capacity, dtype=_I32, device=bkey.device)
    buckets = max(128, _hp_ops.next_pow2(2 * max(1, build.capacity)) // 4)
    heads, tails, ov = _hp_ops.build_bucket_table64(
        bkey, rows, buckets, cap=bucket_cap, valid=bkey != KEY_SENTINEL)
    return BuildIndex("hash", build.capacity, ov, heads=heads,
                      tails=tails)


def probe_index(index: BuildIndex, probe_key: torch.Tensor,
                probe_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe an index.  Returns (matched, build_row_idx); idx arbitrary where
    unmatched (callers mask through ``matched``)."""
    pk = probe_key.to(_I64)
    if index.method == "sorted":
        pos = torch.searchsorted(index.sorted_keys, pk)
        pos = torch.clamp(pos, max=index.capacity - 1)
        matched = (index.sorted_keys[pos] == pk) & probe_valid & \
            (pk != KEY_SENTINEL)
        return matched, index.sorted_rows[pos]
    row = _hp_ops.hash_probe64(pk, index.heads, index.tails)
    matched = (row >= 0) & probe_valid & (pk != KEY_SENTINEL)
    return matched, torch.clamp(row, min=0).to(_I64)


def _probe(probe_key, probe_valid, build: Table, build_key,
           index: BuildIndex | None, method: str):
    if index is None:
        index = build_index(build, build_key, method)
    return probe_index(index, probe_key, probe_valid)


def join_unique(probe: Table, build: Table, probe_on: torch.Tensor,
                build_on: torch.Tensor, take: Sequence[str],
                index: BuildIndex | None = None,
                method: str = "sorted") -> Table:
    """Inner join; ``build`` keys must be unique among valid rows.  Output =
    probe rows that matched (masked, no compaction) plus ``take`` columns
    gathered from build; capacity = probe capacity."""
    matched, bidx = _probe(probe_on, probe.valid_mask(), build, build_on,
                           index, method)
    cols = dict(probe.columns)
    for name in take:
        if name in cols:
            raise ValueError(f"join output column collision: {name}")
        cols[name] = build[name][bidx]
    return Table(cols, _count(matched), matched)


def semi_join(probe: Table, build: Table, probe_on, build_on,
              index: BuildIndex | None = None, method: str = "sorted") -> Table:
    matched, _ = _probe(probe_on, probe.valid_mask(), build, build_on,
                        index, method)
    return Table(dict(probe.columns), _count(matched), matched)


def anti_join(probe: Table, build: Table, probe_on, build_on,
              index: BuildIndex | None = None, method: str = "sorted") -> Table:
    matched, _ = _probe(probe_on, probe.valid_mask(), build, build_on,
                        index, method)
    keep = ~matched & probe.valid_mask()
    return Table(dict(probe.columns), _count(keep), keep)


def left_join(probe: Table, build: Table, probe_on, build_on,
              take: Sequence[str], defaults: dict[str, float | int],
              index: BuildIndex | None = None, method: str = "sorted") -> Table:
    """Left outer join; unmatched probe rows take ``defaults``; adds
    ``__matched``."""
    matched, bidx = _probe(probe_on, probe.valid_mask(), build, build_on,
                           index, method)
    cols = dict(probe.columns)
    for name in take:
        gathered = build[name][bidx]
        fill = torch.tensor(defaults[name], dtype=gathered.dtype,
                            device=gathered.device)
        cols[name] = torch.where(matched, gathered, fill)
    cols["__matched"] = matched
    return Table(cols, probe.count, probe.valid)


# ---------------------------------------------------------------------------
# grouped aggregation
# ---------------------------------------------------------------------------

def _agg_value(t: Table, values, cap: int) -> torch.Tensor:
    """Materialize an agg value spec (tensor | column name | None=ones |
    Python scalar)."""
    if values is None:
        return torch.ones(cap, dtype=_I64, device=t.device)
    if isinstance(values, str):
        return t[values]
    if not isinstance(values, torch.Tensor):
        return torch.full((cap,), values, device=t.device,
                          dtype=torch.float64 if isinstance(values, float)
                          else _I64)
    return values


def _dtype_max(dt: torch.dtype):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _dtype_min(dt: torch.dtype):
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def group_aggregate(t: Table, key_cols: Sequence[str],
                    aggs: Sequence[tuple[str, str, torch.Tensor | str | None]],
                    key_bits: Sequence[int] | None = None,
                    method: str = "auto", return_overflow: bool = False,
                    groups_hint: int | None = None,
                    hash_factor: float = 2.0):
    """Grouped aggregation; sortless when the key domain is provably small
    OR a distinct-group bound is claimed.

    Paths (``method``): ``"direct"`` — the packed key IS the dense group id
    (domain ``2^sum(key_bits) <= 2^13``), aggregates through ``segsum``,
    dense slots compacted by a cumsum rank, zero sorts; no key columns is
    the domain-1 case.  ``"hash"`` — a ``groups_hint * hash_factor``-slot
    dictionary (``hash_group``) maps rows to slots, slots rank to
    ascending-key dense ids, aggregates through ``segsum``, zero sorts; 1-2
    key columns, ``groups_hint <= HASH_AGG_GROUPS_MAX``.  ``"sort"`` — one
    stable argsort reused for every aggregate.  ``"auto"`` — direct when
    eligible, else hash, else sort.

    aggs: (out_name, op, values), op in {sum, count, min, max}.  A lying
    ``key_bits`` routes out-of-domain valid rows to the dead slot and raises
    the overflow flag; an unplaceable dictionary row raises it too.  Output:
    key columns + agg columns, ascending packed key on every path, count =
    number of groups, capacity preserved, compact.  Rows past ``count`` are
    unspecified and differ between paths.
    """
    direct_ok = (not key_cols) or (
        key_bits is not None and sum(key_bits) <= DIRECT_AGG_BITS_MAX)
    hash_ok = bool(key_cols) and len(key_cols) <= 2 and \
        groups_hint is not None and groups_hint <= HASH_AGG_GROUPS_MAX
    if method == "auto":
        method = "direct" if direct_ok else ("hash" if hash_ok else "sort")
    if method == "direct":
        if not direct_ok:
            raise ValueError("group_aggregate: direct path needs key_bits "
                             f"with sum <= {DIRECT_AGG_BITS_MAX}")
        out, overflow = _group_aggregate_direct(t, key_cols, aggs, key_bits)
    elif method == "hash":
        if not hash_ok:
            raise ValueError("group_aggregate: hash path needs 1-2 key "
                             "columns and groups_hint <= "
                             f"{HASH_AGG_GROUPS_MAX}")
        out, overflow = _group_aggregate_hash(t, key_cols, aggs, groups_hint,
                                              hash_factor)
    elif method == "sort":
        out = _group_aggregate_sorted(t, key_cols, aggs, key_bits)
        overflow = torch.zeros((), dtype=torch.bool, device=t.device)
    else:
        raise ValueError(f"unknown group_aggregate method {method!r}")
    return (out, overflow) if return_overflow else out


def _reduce_aggs(t: Table, aggs, gid: torch.Tensor, dom: int,
                 in_dom: torch.Tensor, cnt: torch.Tensor, cap: int
                 ) -> dict[str, torch.Tensor]:
    """Shared sortless reduction core (direct + hash paths): per-agg (dom,)
    tensors through ``segsum``, same-dtype sums batched into one
    multi-column call.  ``in_dom`` masks rows excluded from every aggregate;
    ``cnt`` is the group occupancy, which doubles as every count."""
    reduced: dict[str, torch.Tensor] = {}
    sum_batches: dict[torch.dtype, list] = {}
    for out_name, op, values in aggs:
        if op == "count":
            reduced[out_name] = cnt
            continue
        v = _agg_value(t, values, cap)
        if op == "sum":
            v = torch.where(in_dom, v, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))
            sum_batches.setdefault(v.dtype, []).append((out_name, v))
        elif op in ("min", "max"):
            fill = _dtype_max(v.dtype) if op == "min" else _dtype_min(v.dtype)
            v = torch.where(in_dom, v, torch.tensor(fill, dtype=v.dtype,
                                                    device=v.device))
            reduced[out_name] = _ss_ops.segment_reduce(gid, v, dom, op=op)
        else:
            raise ValueError(f"unknown agg op {op!r}")
    for items in sum_batches.values():
        stacked = torch.stack([v for _, v in items], dim=1)
        sums = _ss_ops.segment_reduce(gid, stacked, dom, op="sum")
        for i, (name, _) in enumerate(items):
            reduced[name] = sums[:, i]
    return reduced


def _group_aggregate_direct(t: Table, key_cols: Sequence[str], aggs,
                            key_bits: Sequence[int] | None
                            ) -> tuple[Table, torch.Tensor]:
    """Sortless path: dense gid = packed key; segsum; cumsum compaction."""
    cap = t.capacity
    dev = t.device
    valid = t.valid_mask()
    if key_cols:
        bits = list(key_bits)
        dom = 1 << sum(bits)
        key = combine_keys([t[k] for k in key_cols], bits=bits)
        # the bits claim is checked PER COLUMN: an oversized value in a
        # non-leading column would alias an in-range packed key
        in_dom = valid
        for k, b in zip(key_cols, bits):
            c = t[k]
            in_dom = in_dom & (c >= 0) & (c < (1 << b))
    else:
        bits, dom = [], 1
        key = torch.zeros(cap, dtype=_I64, device=dev)
        in_dom = valid
    overflow = (in_dom != valid).any()        # a valid row broke the claim
    gid = torch.where(in_dom, key, dom).to(_I32)     # dead slot = dom

    cnt = _ss_ops.segment_reduce(gid, None, dom, op="count")       # (dom,)
    nonempty = cnt > 0
    ngroups = _count(nonempty)
    # dense slots to the front without a sort: the cumsum rank keeps
    # ascending-key order, so the output matches the sorted path row for row
    dst = torch.where(nonempty, torch.cumsum(nonempty, 0) - 1, cap)

    out: dict[str, torch.Tensor] = {}
    shift = sum(bits)
    for k, b in zip(key_cols, bits):
        shift -= b
        dom_keys = (torch.arange(dom, dtype=_I64, device=dev) >> shift) & \
            ((1 << b) - 1)
        out[k] = _drop_scatter(dst, dom_keys.to(t[k].dtype), cap)
    reduced = _reduce_aggs(t, aggs, gid, dom, in_dom, cnt, cap)
    for out_name, _, _ in aggs:
        out[out_name] = _drop_scatter(dst, reduced[out_name], cap)
    return Table(out, ngroups), overflow


def _group_aggregate_hash(t: Table, key_cols: Sequence[str], aggs,
                          groups_hint: int, hash_factor: float
                          ) -> tuple[Table, torch.Tensor]:
    """Hash-compaction path: dictionary -> ascending-key dense gid ->
    segsum.  Unplaced rows are excluded from every aggregate (never
    misassigned) and raise the overflow flag, as does a group count above
    ``groups_hint``."""
    cap = t.capacity
    valid = t.valid_mask()
    key = combine_keys([t[k] for k in key_cols])
    dcap = _hg_ops.dict_capacity(groups_hint, hash_factor)
    slot, dkeys, occupied, unresolved = _hg_ops.build_group_dict(
        key, valid, dcap)
    rank = _hg_ops.dict_rank(dkeys, occupied)          # dcap for empty slots
    ngroups = _count(occupied)
    overflow = unresolved | (ngroups > groups_hint)
    resolved = valid & (slot >= 0)
    # gid IS the final output row (ascending key): no compaction scatter
    gid = torch.where(resolved, rank[torch.clamp(slot, min=0).to(_I64)],
                      dcap).to(_I32)

    def _fit(dom_vals: torch.Tensor) -> torch.Tensor:
        if dcap >= cap:
            return dom_vals[:cap]
        out = torch.zeros(cap, dtype=dom_vals.dtype, device=dom_vals.device)
        out[:dcap] = dom_vals
        return out

    out: dict[str, torch.Tensor] = {}
    # key columns scatter from the rows themselves (a group's rows share the
    # value, so duplicate writes are benign)
    gid_drop = torch.where(resolved, gid, cap).to(_I64)
    for k in key_cols:
        out[k] = _drop_scatter(gid_drop.clamp(max=cap), t[k], cap)
    cnt = _ss_ops.segment_reduce(gid, None, dcap, op="count")
    reduced = _reduce_aggs(t, aggs, gid, dcap, resolved, cnt, cap)
    for out_name, _, _ in aggs:
        out[out_name] = _fit(reduced[out_name])
    return Table(out, ngroups), overflow


def _group_aggregate_sorted(t: Table, key_cols: Sequence[str], aggs,
                            key_bits: Sequence[int] | None = None) -> Table:
    """Sort-based path: exactly ONE stable argsort, its order reused for
    every aggregate (segment reductions over the same segments)."""
    cap = t.capacity
    dev = t.device
    if key_cols:
        key = _valid_key(t, combine_keys([t[k] for k in key_cols],
                                         bits=key_bits))
    else:
        key = torch.where(t.valid_mask(), 0, KEY_SENTINEL).to(_I64)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    valid = sk != KEY_SENTINEL
    first = valid.clone()
    first[1:] = (sk[1:] != sk[:-1]) & valid[1:]
    gid = torch.cumsum(first, 0) - 1                   # 0-based group id
    ngroups = _count(first)
    # invalid rows go to segment cap-1, which is provably not a valid group
    # whenever an invalid row exists (ngroups <= count <= cap-1)
    seg = torch.where(valid, gid, cap - 1)
    run_len = None              # valid rows per group, for the float sums

    out: dict[str, torch.Tensor] = {}
    for k in key_cols:
        v = t[k][order]
        # a group's rows share the key value: duplicate writes are benign;
        # invalid rows write the fill value into slot cap-1
        out[k] = torch.zeros(cap, dtype=v.dtype, device=dev).index_put_(
            (seg,), torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                      device=dev)))
    for out_name, op, values in aggs:
        v = _agg_value(t, values, cap)[order]
        if op == "count":
            v = valid.to(_I64)
            out[out_name] = torch.zeros(cap, dtype=_I64, device=dev) \
                .index_add_(0, seg, v)
        elif op == "sum":
            v = torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                  device=dev))
            if v.is_floating_point():
                # index_add_ adds floats with atomics in no fixed order on
                # CUDA.  Sorted, a group's rows are one run, and the valid
                # runs come first: each is summed in row order (the same
                # bits on every call), and the invalid tail is never read
                if run_len is None:     # invalid rows count into a cut slot
                    run_len = torch.zeros(cap + 1, dtype=_I64, device=dev) \
                        .index_add_(0, torch.where(valid, gid, cap),
                                    torch.ones_like(gid))[:cap]
                out[out_name] = torch.segment_reduce(
                    v, "sum", lengths=run_len, unsafe=True)
            else:
                out[out_name] = torch.zeros(cap, dtype=v.dtype, device=dev) \
                    .index_add_(0, seg, v)
        elif op in ("min", "max"):
            ident = _dtype_max(v.dtype) if op == "min" else _dtype_min(v.dtype)
            v = torch.where(valid, v, torch.tensor(ident, dtype=v.dtype,
                                                   device=dev))
            out[out_name] = torch.full((cap,), ident, dtype=v.dtype,
                                       device=dev).scatter_reduce_(
                0, seg, v, "amin" if op == "min" else "amax")
        else:
            raise ValueError(f"unknown agg op {op!r}")
    return Table(out, ngroups)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

def sort_by(t: Table, keys: Sequence[tuple[str, bool]]) -> Table:
    """ORDER BY; keys = [(column, ascending)], first key most significant.

    One stable lexicographic sort, ties kept in row order; invalid rows sink
    to the back via sentinels in every key operand, so the output is
    compact.  Written as successive stable argsorts from the least
    significant key up."""
    valid = t.valid_mask()
    operands = []
    for col, asc in keys:
        k = t[col]
        if k.is_floating_point():
            k = torch.where(valid, k if asc else -k, float("inf"))
        else:
            k = k.to(_I64)
            k = torch.where(valid, k if asc else -k, KEY_SENTINEL)
        operands.append(k)
    order = torch.arange(t.capacity, device=t.device)
    for k in reversed(operands):
        order = order[torch.argsort(k[order], stable=True)]
    return Table({k: v[order] for k, v in t.columns.items()}, t.count)
