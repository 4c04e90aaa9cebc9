"""Compile logical plans (:mod:`repro_torch.core.plan`) to physical ``Context`` calls.

The planner closes the gap the ROADMAP calls the *hint-threading convention*:
the physical engine's static hints — ``key_bits`` (provable per-column key
widths that unlock the sortless direct-addressing group-by) and
``groups_hint`` (distinct-group bound that shrinks partials before an
exchange) — used to be hand-carried by every query.  Here they are INFERRED
from the plan by bound propagation:

  * **Column statistics.** Host-side min/max per integer column of the
    database (computed once per ``Database`` and cached on it).  Dictionary
    columns are bounded by their dictionary domain (``ctx.dict_bits``'s fact);
    key columns by their generated ranges.  These are trace-time metadata,
    exactly like the string dictionaries.
  * **Refinement through filters.** ``col <cmp> literal`` conjuncts and
    literal-set membership tighten interval and cardinality bounds
    (``l_shipdate`` between two dates bounds ``year(l_shipdate)`` to 2 values).
  * **Interval arithmetic through expressions.** ``with_col`` bounds flow
    through ``+ - *``, ``year``, ``where``, casts; cardinalities multiply.
  * **Inference.** A group-by key column with a provable ``0 <= v <= hi``
    gets ``bits = bit_length(hi)``; when every key is provable and
    ``sum(bits) <= DIRECT_AGG_BITS_MAX`` the planner passes ``key_bits`` and
    the engine takes the sortless direct path (which re-checks each claimed
    width per column at runtime — a mismatch raises the overflow flag, never
    merges groups).  Wider provable widths are deliberately withheld: the
    sorted path's bits-packing carries no runtime check, so it keeps the
    legacy collision-safe packing instead.  The product of key cardinalities
    becomes ``groups_hint``.  A plan-author ``groups_hint=`` survives only
    where inference cannot prove a bound (or is tighter, matching the legacy
    overflow-retry semantics).
  * **Method selection.** When ``key_bits`` is UNPROVABLE but a
    ``groups_hint`` exists (Q13's data-dependent orders-per-customer bound is
    the canonical case), the planner selects the **hash-compaction** path:
    a trace-time on-device dictionary (``kernels/hash_group``) maps rows to
    dense group ids, keeping the group-by sortless with no width claim at
    all.  The dictionary re-checks the claim at runtime — an unplaceable row
    or an undercounting bound raises the overflow flag, and the fault
    runner's capacity escalation scales the dictionary (then drops hints
    entirely, falling back to the single-sort path, if escalation cannot
    help).

Everything inferred is *provable from the database that runs*, so a lying
bound is impossible on the data it was derived from.  A compile whose tables
are NOT the analyzed database (stand-in lowering like the SF=1000 dry-run)
must inject statistics matching the modeled scale or disable inference; as a
backstop, the engine's overflow flag still fires rather than corrupting
results, and the fault runner recompiles without hints after a failed
capacity escalation — inference never weakens the correctness story.

**Exchange placement stays authoritative in the plan** (the paper's §4.4
manual placement).  The planner derives a placement of its own from the §4.3
input partitioning and *validates*: redundant broadcasts/shuffles, group-bys
whose explicit ``local``/exchange disagrees with the derived device-
disjointness, and ``finalize(replicated=)`` flags that contradict the derived
distribution are reported via :func:`validate` / ``CompiledQuery.validate`` —
reported, never silently rewritten.  Paper Table-4 exchange counts are
likewise derived from the IR alone (:func:`static_plan_stats`, no execution).

``REPRO_PLANNER`` selects the default mode: unset/``1`` = inference on;
``0`` = conservative (no hints at all — the legacy unhinted path).  The two
modes are byte-identical per aggregation engine (pinned by
``tests/test_planner.py``; under ``REPRO_AGG_KERNEL=1`` the hinted direct
path sums on the one-hot kernel while the unhinted path uses segment_sum, so
that leg agrees at the same rtol=1e-9 the kernel-vs-oracle suite pins); CI
runs legs with each forced.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from . import plan as P

__all__ = [
    "ColStats", "PlanInfo", "CompiledQuery",
    "analyze", "column_stats", "compile_query", "invalidate_stats",
    "params_of", "plan_signature", "planner_default",
    "register_invalidation", "scan_columns", "static_exchange_stats",
    "static_plan_stats", "static_wire_stats", "stats_override",
    "subplan_signatures", "validate",
]

REPL = "replicated"          # partitioning lattice: REPL | tuple(cols) | None
_MAX_HINT = 1 << 31          # cardinality products beyond this are useless


def planner_default() -> bool:
    """Inference on unless REPRO_PLANNER=0 (the conservative CI leg)."""
    return os.environ.get("REPRO_PLANNER", "1").lower() not in \
        ("0", "false", "off")


# ---------------------------------------------------------------------------
# column statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColStats:
    """Provable bounds for an integer column: ``lo <= v <= hi`` with at most
    ``card`` distinct values.  ``None`` = unknown."""
    lo: int | None = None
    hi: int | None = None
    card: int | None = None

    def clamped(self) -> "ColStats":
        if self.lo is None or self.hi is None:
            return self
        width = max(0, self.hi - self.lo + 1)
        card = width if self.card is None else min(self.card, width)
        return ColStats(self.lo, self.hi, card)


_UNKNOWN = ColStats()


def column_stats(db) -> dict[str, ColStats]:
    """Host-side min/max/cardinality bounds per integer column (cached on db).

    Column names are globally unique in TPC-H (table-prefixed), so one flat
    namespace is enough.  Dictionary-encoded columns additionally clamp to
    their dictionary domain — ``ctx.dict_bits``'s fact, now a planner fact.
    """
    cached = db.__dict__.get("_plan_colstats")
    if cached is not None:
        return cached
    stats: dict[str, ColStats] = {}
    for _tname, cols in db.tables.items():
        for cname, v in cols.items():
            v = np.asarray(v)
            if not np.issubdtype(v.dtype, np.integer) or v.size == 0:
                continue
            lo, hi = int(v.min()), int(v.max())
            if cname in db.dicts:
                lo, hi = max(lo, 0), min(hi, len(db.dicts[cname]) - 1)
            stats[cname] = ColStats(lo, hi).clamped()
    db.__dict__["_plan_colstats"] = stats
    return stats


def _year_of_day(d: int) -> int:
    dt = np.datetime64("1970-01-01") + np.timedelta64(int(d), "D")
    return int(dt.astype("datetime64[Y]").astype(np.int64)) + 1970


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _const(e: P.Expr, db):
    """Resolve a host-constant expression (literals, dictionary codes, scale,
    arithmetic over them); None when not a constant."""
    if isinstance(e, P.Lit):
        return e.value
    if isinstance(e, P.CodeLit):
        return db.code(e.col, e.value)
    if isinstance(e, P.DbScale):
        return db.scale
    if isinstance(e, P.Cast):
        return _const(e.a, db)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*", "/"):
        a, b = _const(e.a, db), _const(e.b, db)
        if a is None or b is None:
            return None
        return {"+": a + b, "-": a - b, "*": a * b,
                "/": a / b if b != 0 else None}[e.op]
    return None


def _const_range(e: P.Expr, db):
    """Resolve an expression of host constants AND domained parameters to the
    closed interval ``(lo, hi)`` of values it can take over every admissible
    binding; ``None`` when unbounded.  A plain constant resolves to the
    degenerate interval ``(c, c)``, so template-free plans refine exactly as
    before — and a :class:`P.Param` contributes its declared domain, which is
    what makes one cached ``PlanInfo`` sound for every binding."""
    if isinstance(e, P.Param):
        return None if e.lo is None else (e.lo, e.hi)
    c = _const(e, db)
    if c is not None:
        return (c, c)
    if isinstance(e, P.Cast):
        return _const_range(e.a, db)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*"):
        a, b = _const_range(e.a, db), _const_range(e.b, db)
        if a is None or b is None:
            return None
        if e.op == "+":
            return (a[0] + b[0], a[1] + b[1])
        if e.op == "-":
            return (a[0] - b[1], a[1] - b[0])
        prods = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
        return (min(prods), max(prods))
    return None


def _mul_interval(a: ColStats, b: ColStats) -> tuple[int, int]:
    prods = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return min(prods), max(prods)


def _card_mul(a, b):
    if a is None or b is None:
        return None
    c = a * b
    return c if c <= _MAX_HINT else None


def _expr_stats(e: P.Expr, schema: dict[str, ColStats], db) -> ColStats:
    """Interval/cardinality bounds for an expression over ``schema``."""
    if isinstance(e, P.Col):
        return schema.get(e.name, _UNKNOWN)
    if isinstance(e, P.Lit):
        return ColStats(int(e.value), int(e.value), 1) if _is_int(e.value) \
            else _UNKNOWN
    if isinstance(e, P.CodeLit):
        c = db.code(e.col, e.value)
        return ColStats(c, c, 1)
    if isinstance(e, P.Param):
        # a template parameter is bounded by its declared DOMAIN (one value
        # per binding, any value across bindings) — never by any binding
        if e.dtype == "int64" and e.lo is not None:
            return ColStats(int(math.ceil(e.lo)), int(math.floor(e.hi)),
                            1).clamped()
        return _UNKNOWN
    if isinstance(e, P.Cast):
        return _expr_stats(e.a, schema, db)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*"):
        a = _expr_stats(e.a, schema, db)
        b = _expr_stats(e.b, schema, db)
        if None in (a.lo, a.hi, b.lo, b.hi):
            return _UNKNOWN
        if e.op == "+":
            lo, hi = a.lo + b.lo, a.hi + b.hi
        elif e.op == "-":
            lo, hi = a.lo - b.hi, a.hi - b.lo
        else:
            lo, hi = _mul_interval(a, b)
        return ColStats(lo, hi, _card_mul(a.card, b.card)).clamped()
    if isinstance(e, P.Year):
        a = _expr_stats(e.a, schema, db)
        if a.lo is None or a.hi is None:
            return _UNKNOWN
        lo, hi = _year_of_day(a.lo), _year_of_day(a.hi)
        return ColStats(lo, hi, a.card).clamped()
    if isinstance(e, P.Where):
        a = _expr_stats(e.a, schema, db)
        b = _expr_stats(e.b, schema, db)
        if None in (a.lo, a.hi, b.lo, b.hi):
            return _UNKNOWN
        card = None if (a.card is None or b.card is None) else a.card + b.card
        return ColStats(min(a.lo, b.lo), max(a.hi, b.hi), card).clamped()
    if isinstance(e, P.AlphaRank):
        n = len(db.dicts[e.col])
        return ColStats(0, n - 1, n)
    return _UNKNOWN


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _refine_filter(pred: P.Expr, schema: dict[str, ColStats], db
                   ) -> dict[str, ColStats]:
    """Tighten column bounds through the conjuncts of a filter predicate.

    Comparisons against host constants AND against domained template
    parameters refine — the latter by the WEAKEST bound over the parameter
    domain (``v <= p`` keeps rows up to the domain's hi, ``v >= p`` down to
    its lo), so the refinement is sound for every binding the template
    admits, not just one literal."""
    out = dict(schema)

    def _mn(a, b):
        return b if a is None else (a if b is None else min(a, b))

    def _mx(a, b):
        return b if a is None else (a if b is None else max(a, b))

    def _num(v) -> bool:
        return isinstance(v, (int, float, np.number)) and \
            not isinstance(v, bool)

    def apply(name: str, op: str, rng):
        s = out.get(name)
        if s is None or rng is None or not (_num(rng[0]) and _num(rng[1])):
            return
        clo, chi = rng
        lo, hi, card = s.lo, s.hi, s.card
        if op == "<=":                       # v <= c, c anywhere in [clo,chi]
            hi = _mn(hi, math.floor(chi))
        elif op == "<":
            hi = _mn(hi, math.ceil(chi) - 1)
        elif op == ">=":
            lo = _mx(lo, math.ceil(clo))
        elif op == ">":
            lo = _mx(lo, math.floor(clo) + 1)
        elif op == "==":
            # v equals SOME value in [clo, chi]: both ends clamp; the
            # surviving width bounds the distinct count (1 for a constant)
            lo = _mx(lo, math.ceil(clo))
            hi = _mn(hi, math.floor(chi))
            if lo is not None and hi is not None:
                card = _mn(card, max(1, hi - lo + 1))
        out[name] = ColStats(lo, hi, card).clamped()

    def visit(e):
        if isinstance(e, P.BinOp) and e.op == "&":
            visit(e.a)
            visit(e.b)
            return
        if isinstance(e, P.BinOp) and e.op in _FLIP:
            if isinstance(e.a, P.Col):
                apply(e.a.name, e.op, _const_range(e.b, db))
            elif isinstance(e.b, P.Col):
                apply(e.b.name, _FLIP[e.op], _const_range(e.a, db))
            return
        if isinstance(e, P.InSet) and isinstance(e.a, P.Col):
            vals = [_const(v, db) for v in e.values]
            if vals and all(_is_int(v) for v in vals):
                s = out.get(e.a.name)
                if s is not None:
                    lo = _mx(s.lo, min(vals))
                    hi = _mn(s.hi, max(vals))
                    card = len(set(vals)) if s.card is None \
                        else min(s.card, len(set(vals)))
                    out[e.a.name] = ColStats(lo, hi, card).clamped()

    visit(pred)
    return out


# ---------------------------------------------------------------------------
# plan walking
# ---------------------------------------------------------------------------

def _expr_children(e: P.Expr):
    if isinstance(e, P.BinOp):
        return (e.a, e.b)
    if isinstance(e, (P.NotE, P.Cast, P.Year)):
        return (e.a,)
    if isinstance(e, P.Where):
        return (e.cond, e.a, e.b)
    if isinstance(e, P.InSet):
        return (e.a,) + e.values
    return ()


def _expr_scalar_nodes(e: P.Expr) -> list:
    """AggScalar nodes referenced (via ScalarRef) inside an expression."""
    out, stack = [], [e]
    while stack:
        x = stack.pop()
        if isinstance(x, P.ScalarRef):
            out.append(x.node)
        stack.extend(_expr_children(x))
    return out


def _node_exprs(node: P.Node):
    if isinstance(node, P.Filter):
        return (node.pred,)
    if isinstance(node, P.WithCol):
        return tuple(node.exprs.values())
    if isinstance(node, (P.GroupBy, P.AggScalar)):
        return tuple(v for _, _, v in node.aggs if isinstance(v, P.Expr))
    if isinstance(node, P.ScalarResult):
        return tuple(node.exprs.values())
    return ()


def walk(root: P.Node) -> list[P.Node]:
    """Every node reachable from ``root`` — through child edges AND through
    scalar sub-queries embedded in expressions — each exactly once."""
    seen: dict[int, P.Node] = {}
    stack = [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen[id(n)] = n
        stack.extend(n.children)
        for e in _node_exprs(n):
            stack.extend(_expr_scalar_nodes(e))
    return list(seen.values())


def static_plan_stats(root: P.Node) -> dict[str, int]:
    """Exchange counts derived from the IR alone — no database, no execution.

    Mirrors the backends' ``_count`` bookkeeping exactly (each DAG node
    executes once), so these equal runtime ``PlanStats.counts()`` on every
    backend and are asserted against paper Table 4 in
    ``tests/test_plan_stats.py``.
    """
    c = {"shuffles": 0, "broadcasts": 0, "final_gathers": 0, "allreduces": 0}
    for n in walk(root):
        if isinstance(n, P.Shuffle):
            c["shuffles"] += 1
        elif isinstance(n, P.Broadcast):
            c["broadcasts"] += 1
        elif isinstance(n, P.GroupBy):
            if n.exchange == "shuffle":
                c["shuffles"] += 1
            elif n.exchange == "gather":
                c["final_gathers" if n.final else "broadcasts"] += 1
        elif isinstance(n, P.AggScalar):
            c["allreduces"] += 1
        elif isinstance(n, P.Finalize) and not n.replicated:
            c["final_gathers"] += 1
    return c


# ---------------------------------------------------------------------------
# content plan signatures (compiled-plan cache keys + lineage fingerprints)
# ---------------------------------------------------------------------------

def _expr_sig(e: P.Expr, nsig) -> str:
    """Canonical serialization of an expression tree.  ``nsig(node)`` resolves
    an embedded scalar sub-query (:class:`P.ScalarRef`) to a stable string."""
    if isinstance(e, P.Col):
        return f"c:{e.name}"
    if isinstance(e, P.Lit):
        return f"l:{e.value!r}"
    if isinstance(e, P.CodeLit):
        return f"sc:{e.col}={e.value!r}"
    if isinstance(e, P.DbScale):
        return "dbscale"
    if isinstance(e, P.Param):
        return f"prm:{e.spec()!r}"
    if isinstance(e, P.ScalarRef):
        return f"sq:{nsig(e.node)}[{e.name}]"
    if isinstance(e, P.BinOp):
        return f"({_expr_sig(e.a, nsig)}{e.op}{_expr_sig(e.b, nsig)})"
    if isinstance(e, P.NotE):
        return f"~({_expr_sig(e.a, nsig)})"
    if isinstance(e, P.Cast):
        return f"cast[{e.dtype}]({_expr_sig(e.a, nsig)})"
    if isinstance(e, P.Where):
        return (f"where({_expr_sig(e.cond, nsig)},{_expr_sig(e.a, nsig)},"
                f"{_expr_sig(e.b, nsig)})")
    if isinstance(e, P.Year):
        return f"year({_expr_sig(e.a, nsig)})"
    if isinstance(e, P.AlphaRank):
        return f"rank:{e.col}"
    if isinstance(e, P.Like):
        return f"like:{e.col}~{e.subs!r}"
    if isinstance(e, P.StartsWith):
        return f"pre:{e.col}~{e.prefix!r}"
    if isinstance(e, P.EndsWith):
        return f"suf:{e.col}~{e.suffix!r}"
    if isinstance(e, P.InSet):
        vals = ",".join(_expr_sig(v, nsig) for v in e.values)
        return f"in({_expr_sig(e.a, nsig)};{vals})"
    raise TypeError(f"cannot serialize {type(e).__name__}")


def _aggs_sig(aggs, nsig) -> str:
    parts = []
    for name, op, v in aggs:
        if v is None:
            vs = "-"
        elif isinstance(v, str):
            vs = f"c:{v}"
        else:
            vs = _expr_sig(v, nsig)
        parts.append(f"{name}={op}({vs})")
    return ",".join(parts)


def _node_sig(n: P.Node, nsig) -> str:
    """One node's own content (type + every semantic attribute + expression
    trees); children/sub-queries are referenced through ``nsig``, never
    inlined, so the caller chooses identity- or content-addressing."""
    t = type(n).__name__
    if isinstance(n, P.Scan):
        return f"{t}:{n.table}"
    if isinstance(n, P.Filter):
        return f"{t}:{_expr_sig(n.pred, nsig)}"
    if isinstance(n, P.Select):
        return f"{t}:{','.join(n.names)}"
    if isinstance(n, P.WithCol):
        # insertion order kept: a later expr may read an earlier new column
        inner = ",".join(f"{k}={_expr_sig(e, nsig)}"
                         for k, e in n.exprs.items())
        return f"{t}:{inner}"
    if isinstance(n, P.Rename):
        return f"{t}:{sorted(n.mapping.items())!r}"
    if isinstance(n, P.Left):
        return (f"{t}:on={n.on!r}/{n.build_on!r}:take={n.take!r}"
                f":def={sorted(n.defaults.items())!r}")
    if isinstance(n, P.Join):
        return f"{t}:on={n.on!r}/{n.build_on!r}:take={n.take!r}"
    if isinstance(n, (P.Semi, P.Anti)):
        return f"{t}:on={n.on!r}/{n.build_on!r}"
    if isinstance(n, P.GroupBy):
        return (f"{t}:keys={list(n.keys)!r}:aggs={_aggs_sig(n.aggs, nsig)}"
                f":x={n.exchange}:final={n.final}:gh={n.groups_hint}")
    if isinstance(n, P.AggScalar):
        return f"{t}:aggs={_aggs_sig(n.aggs, nsig)}"
    if isinstance(n, P.Shuffle):
        return f"{t}:{n.key}"
    if isinstance(n, P.Broadcast):
        return f"{t}:p2p={n.p2p}"
    if isinstance(n, P.Shrink):
        return f"{t}:{n.cap}"
    if isinstance(n, P.Finalize):
        return (f"{t}:sort={n.sort_keys!r}:limit={n.limit}"
                f":repl={n.replicated}")
    if isinstance(n, P.ScalarResult):
        inner = ",".join(f"{k}={_expr_sig(e, nsig)}"
                         for k, e in n.exprs.items())
        return f"{t}:{inner}"
    raise TypeError(f"cannot serialize {t}")


def plan_signature(root: P.Node) -> str:
    """CONTENT signature of a plan: every node in deterministic ``walk``
    order — type, semantic attributes, expression trees (parameters by their
    full spec, never a binding) — plus the exact child/sub-query wiring by
    walk ordinal.  Two plans share a signature iff they are the same logical
    program, so it is the key material for the compiled-plan cache and (with
    the bindings appended) the lineage fingerprint; same-shaped plans with
    different columns, keys, literals or DAG sharing all diverge — the
    collision class of the old type-name-only fingerprint."""
    return _walk_signature(walk(root))


def _walk_signature(nodes) -> str:
    """:func:`plan_signature` body over an already-walked node list — shared
    with :func:`repro_torch.distributed.lineage.plan_fingerprint`, which
    receives the executor's walk order rather than a root."""
    ordinal = {id(n): i for i, n in enumerate(nodes)}

    def nsig(m):
        return f"#{ordinal[id(m)]}"

    parts = []
    for i, n in enumerate(nodes):
        kids = ",".join(f"#{ordinal[id(c)]}" for c in n.children)
        parts.append(f"{i}={_node_sig(n, nsig)}<-[{kids}]")
    return ";".join(parts)


def subplan_signatures(root: P.Node) -> dict[int, tuple[str, frozenset]]:
    """Per-node ``id -> (subtree content hash, reachable parameter names)``.

    The hash content-addresses the whole SUBTREE (scalar sub-queries
    inlined), so two queries in a batch that share a logical subplan — same
    scan, same filtered fragment — hash alike even when built as distinct
    objects: the serving batch executor's cross-query memo keys on it.  The
    parameter set names which bindings the subtree's result can depend on, so
    the memo key only includes the bindings that matter."""
    memo: dict[int, tuple[str, frozenset]] = {}

    def expr_params(e: P.Expr, acc: set):
        if isinstance(e, P.Param):
            acc.add(e.name)
        elif isinstance(e, P.ScalarRef):
            acc.update(sub(e.node)[1])
        for ch in _expr_children(e):
            expr_params(ch, acc)

    def sub(n: P.Node) -> tuple[str, frozenset]:
        got = memo.get(id(n))
        if got is not None:
            return got
        local = _node_sig(n, lambda m: sub(m)[0])
        pnames: set = set()
        for e in _node_exprs(n):
            expr_params(e, pnames)
        kids = [sub(ch) for ch in n.children]
        text = local + "|" + ",".join(h for h, _ in kids)
        for _h, ps in kids:
            pnames.update(ps)
        out = (hashlib.blake2b(text.encode(), digest_size=16).hexdigest(),
               frozenset(pnames))
        memo[id(n)] = out
        return out

    sub(root)
    return memo


def params_of(root: P.Node) -> dict[str, P.Param]:
    """Every parameter placeholder reachable from ``root``, by name.  Two
    placeholders sharing a name must agree on the full spec (domain, default,
    dtype) — a conflict is an authoring error, raised here."""
    out: dict[str, P.Param] = {}

    def visit_expr(e: P.Expr):
        if isinstance(e, P.Param):
            prev = out.get(e.name)
            if prev is not None and prev.spec() != e.spec():
                raise ValueError(
                    f"param {e.name!r}: conflicting declarations "
                    f"{prev.spec()} vs {e.spec()}")
            out[e.name] = e
        for ch in _expr_children(e):
            visit_expr(ch)

    for n in walk(root):
        for e in _node_exprs(n):
            visit_expr(e)
    return out


# ---------------------------------------------------------------------------
# static wire-byte derivation (dtype propagation over the IR, no execution)
# ---------------------------------------------------------------------------

def _expr_scalar_nodes_ordered(e: P.Expr) -> list:
    """AggScalar nodes inside an expression, in EVALUATION order (the order
    ``_Executor._eval`` resolves ScalarRefs) — unlike the unordered
    :func:`_expr_scalar_nodes` walk used for reachability."""
    out: list = []
    if isinstance(e, P.ScalarRef):
        out.append(e.node)
    for ch in _expr_children(e):
        out.extend(_expr_scalar_nodes_ordered(ch))
    return out


def _agg_dtype(op: str, operand) -> np.dtype:
    """Aggregate output dtype, matching all three engines (count -> int64;
    integer sums -> int64; float sums / min / max preserve the operand)."""
    if op == "count":
        return np.dtype(np.int64)
    dt = np.result_type(operand)
    if op == "sum":
        return np.dtype(np.int64) if dt.kind in "biu" else dt
    if op == "avg":
        return np.dtype(np.float64)
    return dt                                   # min / max


def _expand_avg_static(aggs):
    """avg -> (__name_s sum, __name_c count): the PARTIAL column set an
    exchanged group-by actually moves (mirrors ``backend._expand_avg``)."""
    out = []
    for name, op, v in aggs:
        if op == "avg":
            out.append((f"__{name}_s", "sum", v))
            out.append((f"__{name}_c", "count", None))
        else:
            out.append((name, op, v))
    return out


class _DtypeWalker:
    """Column-dtype propagation over a plan DAG.

    Mirrors the executors' value semantics at the type level only (numpy and
    jnp promote identically for this engine's dtypes under x64), so the
    static wire layout of every exchange payload can be derived from the IR
    with no execution."""

    def __init__(self, db):
        self.db = db
        self.memo: dict[int, dict[str, np.dtype]] = {}

    # -- expressions: operand is an np.dtype or a host scalar (weak) --------
    def _operand(self, e: P.Expr, sdt: dict):
        if isinstance(e, P.Col):
            return sdt[e.name]
        if isinstance(e, P.Lit):
            return e.value
        if isinstance(e, P.CodeLit):
            return self.db.code(e.col, e.value)
        if isinstance(e, P.DbScale):
            return self.db.scale
        if isinstance(e, P.Param):
            return np.dtype(e.dtype)     # pinned: re-binding never re-types
        if isinstance(e, P.Cast):
            return np.dtype(e.dtype)
        if isinstance(e, P.ScalarRef):
            for name, op, v in e.node.aggs:
                if name == e.name:
                    child_dt = self.dtypes(e.node.children[0])
                    return _agg_dtype(op, self._operand_of_agg(v, child_dt))
            raise KeyError(e.name)
        if isinstance(e, P.BinOp):
            if e.op in ("<", "<=", ">", ">=", "==", "!="):
                return np.dtype(np.bool_)
            a = self._operand(e.a, sdt)
            b = self._operand(e.b, sdt)
            # & | promote like the executors' generic bitwise ops: bool for
            # bool operands (the filter-mask case), integer for integer ones
            r = np.result_type(a, b)
            if e.op == "/" and r.kind in "biu":
                return np.dtype(np.float64)     # true division
            return r
        if isinstance(e, P.NotE):
            return np.result_type(self._operand(e.a, sdt))
        if isinstance(e, P.Where):
            return np.result_type(self._operand(e.a, sdt),
                                  self._operand(e.b, sdt))
        if isinstance(e, (P.Year, P.AlphaRank)):
            return np.dtype(np.int64)
        if isinstance(e, (P.Like, P.StartsWith, P.EndsWith, P.InSet)):
            return np.dtype(np.bool_)
        raise TypeError(f"cannot type {type(e).__name__}")

    def _operand_of_agg(self, v, sdt):
        """Agg value spec: column name | expression | None (count)."""
        if v is None:
            return np.dtype(np.int64)
        if isinstance(v, str):
            return sdt[v]
        return self._operand(v, sdt)

    def expr_dtype(self, e: P.Expr, sdt: dict) -> np.dtype:
        return np.result_type(self._operand(e, sdt))

    # -- nodes --------------------------------------------------------------
    def dtypes(self, n: P.Node) -> dict[str, np.dtype]:
        got = self.memo.get(id(n))
        if got is not None:
            return got
        if isinstance(n, P.Scan):
            s = {c: np.dtype(v.dtype)
                 for c, v in self.db.tables[n.table].items()}
        elif isinstance(n, (P.Filter, P.Shuffle, P.Broadcast, P.Shrink)):
            s = dict(self.dtypes(n.children[0]))
        elif isinstance(n, P.Select):
            ch = self.dtypes(n.children[0])
            s = {c: ch[c] for c in n.names}
        elif isinstance(n, P.WithCol):
            s = dict(self.dtypes(n.children[0]))
            for name, e in n.exprs.items():
                s[name] = self.expr_dtype(e, s)
        elif isinstance(n, P.Rename):
            s = {n.mapping.get(c, c): v
                 for c, v in self.dtypes(n.children[0]).items()}
        elif isinstance(n, (P.Join, P.Left)):
            s = dict(self.dtypes(n.probe))
            bs = self.dtypes(n.build)
            for c in n.take:
                s[c] = bs[c]
            if isinstance(n, P.Left):
                s["__matched"] = np.dtype(np.bool_)
        elif isinstance(n, (P.Semi, P.Anti)):
            s = dict(self.dtypes(n.probe))
        elif isinstance(n, P.GroupBy):
            ch = self.dtypes(n.children[0])
            s = {k: ch[k] for k in n.keys}
            for name, op, v in n.aggs:
                s[name] = _agg_dtype(op, self._operand_of_agg(v, ch))
        else:           # Finalize / ScalarResult / AggScalar: not a table
            s = {}
        self.memo[id(n)] = s
        return s

    def payload(self, n: P.Node) -> dict[str, np.dtype]:
        """Column dtypes of the payload an exchange node moves."""
        if isinstance(n, P.GroupBy):
            ch = self.dtypes(n.children[0])
            s = {k: ch[k] for k in n.keys}
            for name, op, v in _expand_avg_static(n.aggs):
                s[name] = _agg_dtype(op, self._operand_of_agg(v, ch))
            return s
        return self.dtypes(n.children[0])


def _execution_order(root: P.Node) -> list[P.Node]:
    """Every node of the plan in EXECUTION order (the order the backends
    log ``ExchangeStats``): a node after its children, then after the
    scalar sub-queries of its expressions."""
    out: list[P.Node] = []
    seen: set[int] = set()

    def visit(n: P.Node):
        if id(n) in seen:
            return
        seen.add(id(n))
        for ch in n.children:
            visit(ch)
        for e in _node_exprs(n):
            for sub in _expr_scalar_nodes_ordered(e):
                visit(sub)
        out.append(n)

    visit(root)
    return out


def _exchange_nodes(root: P.Node) -> list[tuple[str, P.Node]]:
    """``(kind, node)`` of every exchange of the plan, in execution order."""
    out: list[tuple[str, P.Node]] = []
    for n in _execution_order(root):
        if isinstance(n, P.Shuffle):
            out.append(("shuffle", n))
        elif isinstance(n, P.Broadcast):
            out.append(("broadcast_p2p" if n.p2p else "broadcast", n))
        elif isinstance(n, P.GroupBy) and n.exchange != "local":
            out.append(("shuffle" if n.exchange == "shuffle"
                        else ("gather" if n.final else "broadcast"), n))
        elif isinstance(n, P.Finalize) and not n.replicated:
            out.append(("gather", n))
    return out


def _wire_formats(root: P.Node, db, narrow: bool, info: "PlanInfo | None"):
    """``(kind, node, WireFormat)`` per exchange, in execution order."""
    from . import wire as wi      # deferred, as in the reference planner
    dtw = _DtypeWalker(db)
    out = []
    for kind, n in _exchange_nodes(root):
        dt = dtw.payload(n)
        # the p2p broadcast is the §7.1 baseline and stays wide
        use_narrow = narrow and kind != "broadcast_p2p"
        # the format's OWN verdict counts: plan_wire_format may demote a
        # latency-bound message to wide (wire.hockney_skip), and runtime
        # stats tag what actually shipped
        out.append((kind, n, wi.plan_wire_format(
            sorted(dt), dt, bounds=info.wire_for(n) if use_narrow else None,
            narrow=use_narrow)))
    return out


def static_wire_stats(root: P.Node, db, narrow: bool = True,
                      info: "PlanInfo | None" = None) -> list[dict]:
    """Per-exchange wire descriptors derived from the IR alone — no execution.

    Returns, in EXECUTION order (the order the backends log
    ``ExchangeStats``), one entry per exchange:
    ``{kind, row_wire_bytes, row_logical_bytes, wire}``.  These equal the
    runtime stats on every backend (asserted in ``tests/test_wire.py``), so
    wire-byte budgets are CI-gateable on CPU with no cluster
    (``benchmarks/bench_exchange_bytes.py``).  Pass a cached ``info``
    (``CompiledQuery.info``) to skip re-analysis; the wide leg needs no
    bounds and never analyzes.
    """
    if info is None and narrow:
        info = analyze(root, db)
    return [{"kind": kind, "row_wire_bytes": fmt.row_wire_bytes,
             "row_logical_bytes": fmt.row_logical_bytes,
             "wire": "narrow" if fmt.narrow else "wide"}
            for kind, _, fmt in _wire_formats(root, db, narrow, info)]


def static_exchange_stats(root: P.Node, db, caps: dict[str, int], n: int,
                          capacity_factor: float = 2.0, packed: bool = True,
                          narrow: bool = True,
                          info: "PlanInfo | None" = None):
    """The ``PlanStats`` that ``DistContext`` logs running ``root`` on ``n``
    ranks, planner inference on, derived from the IR and each table's
    capacity per rank (``caps``) alone — nothing runs, nothing is allocated.

    Each exchange's ``ExchangeStats`` follows the engine's capacity rules:
    a filter, select, projection, rename or join keeps its (probe) input's
    capacity; ``Shrink`` and a group-by's inferred ``groups_hint`` cut it
    (``relational.static_shrink``); a shuffle sends ``max(8, ceil(cap *
    capacity_factor / n))`` rows to each rank and outputs ``n`` times that;
    a broadcast or gather sends its input's capacity and outputs ``n`` times
    it; the final gather sends ``min(cap, limit)``.  Packed, a message is
    one header row plus its rows at the wire format's width; per column
    (``packed=False``) it is its rows at full width plus 4 bytes of counts.
    """
    from . import backend as B          # deferred: backend imports the planner
    from . import exchange as ex
    if info is None:
        info = analyze(root, db)
    caps_of: dict[int, int] = {}

    def per_dest(c: int) -> int:        # DistContext._cap_per_dest
        return max(8, math.ceil(c * capacity_factor / n))

    def partial(g: P.GroupBy) -> int:   # the partial, shrunk to groups_hint
        c, gh = cap(g.children[0]), info.hints_for(g)[1]
        return c if gh is None else min(c, gh)

    def sent(x: P.Node) -> int:
        """Rows of one message block of an exchange node."""
        if isinstance(x, P.GroupBy):
            return per_dest(partial(x)) if x.exchange == "shuffle" \
                else partial(x)
        if isinstance(x, P.Shuffle):
            return per_dest(cap(x.children[0]))
        c = cap(x.children[0])
        if isinstance(x, P.Finalize) and x.limit is not None:
            return min(c, x.limit)      # the local top-k before the gather
        return c

    def cap(x: P.Node) -> int:
        got = caps_of.get(id(x))
        if got is not None:
            return got
        if isinstance(x, P.Scan):
            c = caps[x.table]
        elif isinstance(x, P._JoinBase):
            c = cap(x.probe)
        elif isinstance(x, P.Shrink):
            c = min(cap(x.children[0]), x.cap)
        elif isinstance(x, (P.Shuffle, P.Broadcast)):
            c = n * sent(x)
        elif isinstance(x, P.GroupBy):
            c = partial(x) if x.exchange == "local" else n * sent(x)
        else:                           # filter, select, with_col, rename
            c = cap(x.children[0])
        caps_of[id(x)] = c
        return c

    stats = B.PlanStats(**static_plan_stats(root))
    stats.overflow_checks = sum(isinstance(x, P.Shrink) for x in walk(root))
    for kind, x, fmt in _wire_formats(root, db, narrow and packed, info):
        rows, width = sent(x), fmt.row_wire_bytes
        if kind == "broadcast_p2p":     # N - 1 permutes + the counts gather
            msg, collectives = rows * width + 4, n
        elif packed:                    # + the header row: one collective
            msg, collectives = (rows + 1) * width, 1
        else:                           # a collective per column + counts
            msg, collectives = rows * width + 4, len(fmt.cols) + 1
        stats.log.append(ex.ExchangeStats(
            kind=kind, participants=n, message_bytes=msg,
            total_bytes=msg * (n if kind == "shuffle" else n - 1),
            collectives=collectives,
            logical_bytes=rows * fmt.row_logical_bytes,
            row_wire_bytes=width, row_logical_bytes=fmt.row_logical_bytes,
            wire="narrow" if fmt.narrow else "wide"))
    return stats


def _expr_columns(e: P.Expr) -> set[str]:
    """Columns an expression reads."""
    out: set[str] = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, P.Col):
            out.add(x.name)
        elif isinstance(x, (P.AlphaRank, P.Like, P.StartsWith, P.EndsWith)):
            out.add(x.col)
        stack.extend(_expr_children(x))
    return out


def _agg_columns(aggs) -> set[str]:
    out: set[str] = set()
    for _, _, v in aggs:
        if isinstance(v, str):
            out.add(v)
        elif isinstance(v, P.Expr):
            out |= _expr_columns(v)
    return out


def _key_columns(on) -> set[str]:
    return {on} if isinstance(on, str) else set(on)


def scan_columns(root: P.Node, db) -> list[tuple[str, list[str]]]:
    """``(table, columns)`` per ``Scan`` of the plan: the columns of the
    table that the plan reads, from the IR alone.

    Demand flows from the root down: a result, an exchange or a final gather
    needs every column of its input; a group-by or scalar aggregate its keys
    and the columns its aggregates read; a filter or projection what its
    consumers need plus what its expressions read; a join the probe columns
    its consumers need plus the join keys, and of the build side the keys
    and the columns it takes."""
    dtw = _DtypeWalker(db)
    order = _execution_order(root)      # reversed: consumers first
    need: dict[int, set[str]] = {id(n): set() for n in order}
    for n in reversed(order):
        want = need[id(n)]
        if isinstance(n, P.Scan):
            continue
        ch = n.children[0] if n.children else None
        if isinstance(n, (P.Finalize, P.Shuffle, P.Broadcast)):
            need[id(ch)] |= set(dtw.dtypes(ch))
        elif isinstance(n, (P.GroupBy, P.AggScalar)):
            need[id(ch)] |= set(getattr(n, "keys", ())) | _agg_columns(n.aggs)
        elif isinstance(n, P.Filter):
            need[id(ch)] |= want | _expr_columns(n.pred)
        elif isinstance(n, P.WithCol):
            need[id(ch)] |= (want - set(n.exprs)).union(
                *(_expr_columns(e) for e in n.exprs.values()))
        elif isinstance(n, P.Rename):
            back = {new: old for old, new in n.mapping.items()}
            need[id(ch)] |= {back.get(c, c) for c in want}
        elif isinstance(n, P._JoinBase):
            need[id(n.probe)] |= (want & set(dtw.dtypes(n.probe))) | \
                _key_columns(n.on)
            need[id(n.build)] |= set(getattr(n, "take", ())) | \
                _key_columns(n.build_on)
        elif isinstance(n, (P.Select, P.Shrink)):
            need[id(ch)] |= want
    return [(n.table, sorted(need[id(n)] & set(db.tables[n.table])))
            for n in order if isinstance(n, P.Scan)]


# ---------------------------------------------------------------------------
# analysis: schemas, hints, derived placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanInfo:
    """Result of :func:`analyze`: per-group-by inferred hints, the derived
    partitioning per node, per-exchange wire bounds, validation notes, and
    static exchange counts."""
    group_hints: dict[int, tuple[tuple[int, ...] | None, int | None]]
    parts: dict[int, Any]
    notes: list[str]
    counts: dict[str, int]
    # per exchange-performing node: {column: (lo, hi)} provable value bounds
    # of the payload — the statistics the narrow wire format is derived from
    wire: dict[int, dict[str, tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    # per group-by: explicit aggregation method, or None for the engine's
    # own direct/sort auto-dispatch.  The one rule today: "hash" when a
    # groups_hint exists (author-claimed or inferred) but key_bits is
    # unprovable — the data-dependent-domain shape (Q13) the direct path
    # cannot take, extended to zero sorts by the trace-time dictionary.
    methods: dict[int, str] = dataclasses.field(default_factory=dict)

    def hints_for(self, node: P.GroupBy):
        return self.group_hints.get(id(node), (None, None))

    def method_for(self, node: P.GroupBy) -> str | None:
        return self.methods.get(id(node))

    def wire_for(self, node: P.Node):
        return self.wire.get(id(node))


def _partition_keys() -> dict:
    from . import backend as B     # deferred: backend imports the engine
    return B.PARTITION_KEYS


def analyze(root: P.Node, db) -> PlanInfo:
    base = column_stats(db)
    pkeys = _partition_keys()
    schemas: dict[int, dict[str, ColStats]] = {}
    parts: dict[int, Any] = {}
    notes: list[str] = []
    nodes = walk(root)
    consumers: dict[int, list[tuple[P.Node, int]]] = {}
    for n in nodes:
        for i, ch in enumerate(n.children):
            consumers.setdefault(id(ch), []).append((n, i))

    def label(n):
        return type(n).__name__

    # -- schema (column bounds) -------------------------------------------
    def schema(n: P.Node) -> dict[str, ColStats]:
        got = schemas.get(id(n))
        if got is not None:
            return got
        if isinstance(n, P.Scan):
            s = {c: base[c] for c in db.tables[n.table] if c in base}
        elif isinstance(n, P.Filter):
            s = _refine_filter(n.pred, schema(n.children[0]), db)
        elif isinstance(n, P.Select):
            ch = schema(n.children[0])
            s = {c: ch[c] for c in n.names if c in ch}
        elif isinstance(n, P.WithCol):
            s = dict(schema(n.children[0]))
            for name, e in n.exprs.items():
                s[name] = _expr_stats(e, s, db)
        elif isinstance(n, P.Rename):
            s = {n.mapping.get(c, c): v
                 for c, v in schema(n.children[0]).items()}
        elif isinstance(n, (P.Join, P.Left)):
            s = dict(schema(n.probe))
            bs = schema(n.build)
            for c in n.take:
                s[c] = bs.get(c, _UNKNOWN)
            if isinstance(n, P.Left):
                for c in n.take:
                    d = n.defaults.get(c)
                    t = s.get(c, _UNKNOWN)
                    if _is_int(d) and t.lo is not None and t.hi is not None:
                        s[c] = ColStats(min(t.lo, int(d)), max(t.hi, int(d)),
                                        None if t.card is None
                                        else t.card + 1).clamped()
                    else:
                        s[c] = _UNKNOWN
        elif isinstance(n, (P.Semi, P.Anti)):
            s = dict(schema(n.probe))
        elif isinstance(n, P.GroupBy):
            ch = schema(n.children[0])
            s = {k: ch.get(k, _UNKNOWN) for k in n.keys}
            for name, op, v in n.aggs:
                if op in ("min", "max"):
                    s[name] = ch.get(v, _UNKNOWN) if isinstance(v, str) else \
                        (_expr_stats(v, ch, db) if isinstance(v, P.Expr)
                         else _UNKNOWN)
                elif op == "count":
                    s[name] = ColStats(0, None, None)
                else:
                    s[name] = _UNKNOWN
        elif isinstance(n, (P.Shuffle, P.Broadcast, P.Shrink)):
            s = schema(n.children[0])
        else:           # Finalize / ScalarResult / AggScalar: not a table
            s = {}
        schemas[id(n)] = s
        return s

    # -- derived placement -------------------------------------------------
    def part(n: P.Node):
        got = parts.get(id(n), "__miss__")
        if got != "__miss__":
            return got
        p: Any
        if isinstance(n, P.Scan):
            k = pkeys.get(n.table)
            p = REPL if k is None else (k,)
        elif isinstance(n, (P.Filter, P.Select, P.Shrink)):
            p = part(n.children[0])
        elif isinstance(n, P.WithCol):
            p = part(n.children[0])
            if isinstance(p, tuple) and any(c in n.exprs for c in p):
                p = None            # partition column overwritten: unknown
        elif isinstance(n, P.Rename):
            p = part(n.children[0])
            if isinstance(p, tuple):
                p = tuple(n.mapping.get(c, c) for c in p)
        elif isinstance(n, P.Shuffle):
            p = (n.key,)
        elif isinstance(n, P.Broadcast):
            p = REPL
        elif isinstance(n, P._JoinBase):
            p = _join_part(n)
        elif isinstance(n, P.GroupBy):
            if n.exchange == "local":
                p = part(n.children[0])
            elif n.exchange == "shuffle":
                p = tuple(n.keys)
            else:
                p = REPL
        else:
            p = None
        parts[id(n)] = p
        return p

    def _translate(build_part, pairs):
        m = {b: pr for pr, b in pairs}
        if all(c in m for c in build_part):
            return tuple(m[c] for c in build_part)
        return None

    def _join_part(n: P._JoinBase):
        pp, bp = part(n.probe), part(n.build)
        pairs = n.on_pairs()
        if pp is None or bp is None:
            return pp
        if bp == REPL:
            if pp == REPL:
                return REPL
            return pp
        if pp == REPL:
            # replicated probe x partitioned build: every probe row matches on
            # exactly one device (unique build keys) -> output is partitioned
            # by the probe-side join column (the Q18 idiom); sound for inner
            # joins only — semi/anti would filter by a per-device subset.
            if isinstance(n, P.Join):
                return _translate(bp, pairs)
            notes.append(f"{label(n)}: replicated probe against partitioned "
                         f"build {bp} filters by a per-device subset")
            return None
        if _translate(bp, pairs) == pp:
            return pp               # co-partitioned
        notes.append(f"{label(n)} on {pairs}: build partitioned by {bp}, "
                     f"probe by {pp} — not co-partitioned and build not "
                     f"replicated (an exchange is missing)")
        return pp

    def _membership_only(n: P.Node) -> bool:
        """True if a table is consumed — possibly via select/rename/broadcast
        — only as the build side of semi/anti joins (key membership), where a
        per-device partial group-by is still globally correct."""
        for parent, role in consumers.get(id(n), []):
            if isinstance(parent, (P.Select, P.Rename, P.Broadcast)):
                if not _membership_only(parent):
                    return False
            elif isinstance(parent, (P.Semi, P.Anti)) and role == 1:
                continue
            else:
                return False
        return bool(consumers.get(id(n)))

    # -- validation of explicit placement against the derived one ----------
    for n in nodes:
        part(n)
        if isinstance(n, P.Broadcast) and part(n.children[0]) == REPL:
            notes.append("Broadcast of an already-replicated table "
                         "(removable)")
        elif isinstance(n, P.Shuffle) and part(n.children[0]) == (n.key,):
            notes.append(f"Shuffle to {n.key!r}: input already partitioned "
                         f"by it (removable)")
        elif isinstance(n, P.GroupBy):
            cp = part(n.children[0])
            if n.exchange == "local":
                disjoint = cp == REPL or (isinstance(cp, tuple) and
                                          set(cp) <= set(n.keys))
                if cp is not None and not disjoint and \
                        not _membership_only(n):
                    notes.append(
                        f"group_by(local) on {list(n.keys)} over input "
                        f"partitioned by {cp}: groups span devices and the "
                        f"result is consumed as a global aggregate")
            elif isinstance(cp, tuple) and set(cp) <= set(n.keys):
                notes.append(
                    f"group_by({n.exchange}) on {list(n.keys)}: input already "
                    f"partitioned by {cp} — exchange removable (paper-plan "
                    f"placement kept)")
        elif isinstance(n, P.Finalize):
            cp = part(n.children[0])
            if n.replicated and cp not in (REPL, None):
                notes.append(f"finalize(replicated=True) over input "
                             f"partitioned by {cp}")
            elif not n.replicated and cp == REPL:
                notes.append("finalize gathers an already-replicated table "
                             "(replicated=True would skip the exchange)")

    # -- hint inference ----------------------------------------------------
    # key_bits are only emitted when they unlock the DIRECT path: that path
    # re-checks every claimed width per column at runtime and raises the
    # overflow flag on a mismatch (stale stats, mutated tables).  The sorted
    # path's bits-packing has no such check, so wider provable widths are
    # withheld and multi-column sorted group-bys keep the legacy
    # collision-safe 32-bit-shift packing.
    direct_max = _direct_bits_max()
    hash_max = _hash_groups_max()
    hints: dict[int, tuple] = {}
    methods: dict[int, str] = {}
    for n in nodes:
        if not isinstance(n, P.GroupBy):
            continue
        ch = schema(n.children[0])
        bits: list[int] | None = []
        card: int | None = 1
        for k in n.keys:
            s = ch.get(k, _UNKNOWN)
            if bits is not None and s.lo is not None and s.lo >= 0 \
                    and s.hi is not None:
                bits.append(max(1, int(s.hi).bit_length()))
            else:
                bits = None
            card = _card_mul(card, s.card)
        key_bits = tuple(bits) if (n.keys and bits is not None and
                                   sum(bits) <= direct_max) else None
        gh = card if (n.keys and card is not None) else None
        if n.groups_hint is not None:
            gh = n.groups_hint if gh is None else min(gh, n.groups_hint)
        hints[id(n)] = (key_bits, gh)
        # the hash-compaction rule: a group bound exists (typically a plan-
        # author claim like Q13's orders-per-customer histogram) but the key
        # domain is unprovable — the direct path is out, yet a trace-time
        # dictionary of groups_hint keys keeps the group-by sortless.  The
        # engine re-checks at runtime: an unplaceable row or an undercounting
        # bound raises ctx.overflow, never a silent merge/drop.
        if key_bits is None and gh is not None and gh <= hash_max and \
                1 <= len(n.keys) <= 2:
            methods[id(n)] = "hash"

    # -- wire bounds per exchange payload ----------------------------------
    # The narrow wire format ships each exchanged column at the lane width
    # its provable (lo, hi) bounds allow — the SAME statistics key_bits came
    # from, now applied to every exchanged column instead of group keys only.
    # The engine range-checks every claim at pack time (ctx.overflow on a
    # lie), mirroring key_bits' runtime-check contract.
    def _payload_bounds(schema_map) -> dict[str, tuple[int, int]]:
        return {c: (s.lo, s.hi) for c, s in schema_map.items()
                if s.lo is not None and s.hi is not None}

    wire: dict[int, dict[str, tuple[int, int]]] = {}
    for n in nodes:
        if isinstance(n, (P.Shuffle, P.Broadcast)):
            wire[id(n)] = _payload_bounds(schema(n.children[0]))
        elif isinstance(n, P.Finalize) and not n.replicated:
            wire[id(n)] = _payload_bounds(schema(n.children[0]))
        elif isinstance(n, P.GroupBy) and n.exchange != "local":
            # the exchange moves the PARTIAL aggregate: keys + agg columns
            # (avg's sum/count temporaries are unbounded and ship full-width)
            wire[id(n)] = _payload_bounds(schema(n))

    return PlanInfo(hints, parts, notes, static_plan_stats(root), wire,
                    methods)


def validate(root: P.Node, db) -> list[str]:
    """Disagreements between the plan's explicit exchange placement and the
    placement derived from §4.3 partitioning.  Empty list = clean."""
    return analyze(root, db).notes


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _is_exchange_node(node: P.Node) -> bool:
    """Nodes whose output is a post-exchange (replicated / reshuffled) state
    — the lineage-snapshot cut points."""
    return isinstance(node, (P.Shuffle, P.Broadcast)) or \
        (isinstance(node, P.GroupBy) and node.exchange != "local")


class _Executor:
    """Walk a plan DAG against a physical Context; each node runs once (the
    per-plan memo is also what makes the backend's build-side cache hit).

    When the context carries a ``lineage`` store
    (:class:`repro_torch.distributed.lineage.LineageStore`, single-device
    runs only), every exchange-type node consults the store BEFORE recursing:
    a snapshot hit returns the durable post-exchange table and skips the
    entire subtree — depth-first from the root, so a query resumes from the
    topmost (= last computed, fewest-ops-remaining) durable exchange.  A
    miss executes the node and persists its output.  Tags are the node's
    ordinal in the deterministic ``walk()`` order."""

    def __init__(self, ctx, info: PlanInfo | None,
                 params: dict[str, Any] | None = None):
        self.ctx = ctx
        self.info = info
        self.params = params or {}
        self.memo: dict[int, Any] = {}
        self._tags: dict[int, int] = {}

    def run(self, node: P.Node):
        store = getattr(self.ctx, "lineage", None)
        if store is not None:
            nodes = walk(node)
            self._tags = {id(n): i for i, n in enumerate(nodes)}
            store.begin_executor(nodes, self.info is not None,
                                 getattr(self.ctx, "wire_format", None),
                                 bindings=self.params,
                                 n_devices=getattr(self.ctx,
                                                   "lineage_devices", 1))
        return self._exec(node)

    def _wire(self, node: P.Node):
        """Inferred payload bounds for an exchange node (None = no inference
        -> the engine ships full-width)."""
        return self.info.wire_for(node) if self.info is not None else None

    # -- expressions -------------------------------------------------------
    def _eval(self, e: P.Expr, t):
        ctx = self.ctx
        if isinstance(e, P.Col):
            if t is None:
                raise ValueError(f"column {e.name!r} referenced in a scalar "
                                 "context")
            return t[e.name]
        if isinstance(e, P.Lit):
            return e.value
        if isinstance(e, P.CodeLit):
            return ctx.db.code(e.col, e.value)
        if isinstance(e, P.DbScale):
            return ctx.db.scale
        if isinstance(e, P.Param):
            if e.name in self.params:
                return self.params[e.name]
            if e.default is not None:
                return e.default
            raise ValueError(f"unbound parameter {e.name!r} (no binding, "
                             "no default)")
        if isinstance(e, P.ScalarRef):
            return self._exec(e.node)[e.name]
        if isinstance(e, P.BinOp):
            a = self._eval(e.a, t)
            b = self._eval(e.b, t)
            return _binop(e.op, a, b)
        if isinstance(e, P.NotE):
            return ~self._eval(e.a, t)
        if isinstance(e, P.Cast):
            return ctx.cast(self._eval(e.a, t), e.dtype)
        if isinstance(e, P.Where):
            return ctx.where(self._eval(e.cond, t), self._eval(e.a, t),
                             self._eval(e.b, t))
        if isinstance(e, P.Year):
            return ctx.year(self._eval(e.a, t))
        if isinstance(e, P.AlphaRank):
            return ctx.alpha_rank(t, e.col)
        if isinstance(e, P.Like):
            return ctx.like(t, e.col, *e.subs)
        if isinstance(e, P.StartsWith):
            return ctx.starts_with(t, e.col, e.prefix)
        if isinstance(e, P.EndsWith):
            return ctx.ends_with(t, e.col, e.suffix)
        if isinstance(e, P.InSet):
            x = self._eval(e.a, t)
            m = x == self._eval(e.values[0], t)
            for v in e.values[1:]:
                m = m | (x == self._eval(v, t))
            return m
        raise TypeError(f"cannot evaluate {type(e).__name__}")

    def _aggs(self, aggs):
        out = []
        for name, op, v in aggs:
            if isinstance(v, P.Expr):
                out.append((name, op,
                            lambda tt, e=v: self._eval(e, tt)))
            else:
                out.append((name, op, v))
        return out

    # -- nodes -------------------------------------------------------------
    def _exec(self, node: P.Node):
        if id(node) in self.memo:
            return self.memo[id(node)]
        store = getattr(self.ctx, "lineage", None)
        if store is not None and _is_exchange_node(node):
            tag = self._tags[id(node)]
            # checked BEFORE recursing: a hit skips the whole subtree
            out = store.load(tag, self.ctx)
            if out is None:
                out = self._exec_inner(node)
                store.save(tag, out, self.ctx, node=node)
        else:
            out = self._exec_inner(node)
        self.memo[id(node)] = out
        return out

    def _exec_inner(self, node: P.Node):
        ctx = self.ctx
        if isinstance(node, P.Scan):
            return ctx.scan(node.table)
        if isinstance(node, P.Filter):
            t = self._exec(node.children[0])
            return ctx.filter(t, self._eval(node.pred, t))
        if isinstance(node, P.Select):
            return ctx.select(self._exec(node.children[0]), *node.names)
        if isinstance(node, P.WithCol):
            t = self._exec(node.children[0])
            return ctx.with_col(t, **{
                k: (lambda tt, e=e: self._eval(e, tt))
                for k, e in node.exprs.items()})
        if isinstance(node, P.Rename):
            return ctx.rename(self._exec(node.children[0]), node.mapping)
        if isinstance(node, P.Join):
            return ctx.join(self._exec(node.probe), self._exec(node.build),
                            node.on, node.build_on, list(node.take))
        if isinstance(node, P.Semi):
            return ctx.semi(self._exec(node.probe), self._exec(node.build),
                            node.on, node.build_on)
        if isinstance(node, P.Anti):
            return ctx.anti(self._exec(node.probe), self._exec(node.build),
                            node.on, node.build_on)
        if isinstance(node, P.Left):
            return ctx.left(self._exec(node.probe), self._exec(node.build),
                            node.on, node.build_on, list(node.take),
                            node.defaults)
        if isinstance(node, P.GroupBy):
            t = self._exec(node.children[0])
            if self.info is not None:
                key_bits, gh = self.info.hints_for(node)
                method = self.info.method_for(node) or "auto"
            else:
                # conservative: no hints at all (and hence the sort path)
                key_bits, gh, method = None, None, "auto"
            return ctx.group_by(t, list(node.keys), self._aggs(node.aggs),
                                exchange=node.exchange, final=node.final,
                                groups_hint=gh,
                                key_bits=list(key_bits) if key_bits else None,
                                wire=self._wire(node), method=method)
        if isinstance(node, P.AggScalar):
            t = self._exec(node.children[0])
            return ctx.agg_scalar(t, self._aggs(node.aggs))
        if isinstance(node, P.Shuffle):
            return ctx.shuffle(self._exec(node.children[0]), node.key,
                               wire=self._wire(node))
        if isinstance(node, P.Broadcast):
            return ctx.broadcast(self._exec(node.children[0]), p2p=node.p2p,
                                 wire=self._wire(node))
        if isinstance(node, P.Shrink):
            return ctx.shrink(self._exec(node.children[0]), node.cap)
        if isinstance(node, P.Finalize):
            return ctx.finalize(
                self._exec(node.children[0]),
                sort_keys=list(node.sort_keys) if node.sort_keys else None,
                limit=node.limit, replicated=node.replicated,
                wire=self._wire(node))
        if isinstance(node, P.ScalarResult):
            return {k: self._eval(e, None) for k, e in node.exprs.items()}
        raise TypeError(f"cannot execute {type(node).__name__}")


_BINOPS: dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "&": lambda a, b: a & b, "|": lambda a, b: a | b,
}


def lift_f64(x):
    """An integer or bool torch tensor as float64; anything else unchanged."""
    if isinstance(x, torch.Tensor) and not x.is_floating_point():
        return x.double()
    return x


def _binop(op: str, a, b):
    """``_BINOPS[op](a, b)`` with the reference engine's float64 promotion.

    torch gives float32 for an integer tensor combined with a Python float
    and for integer true division, where numpy and JAX under x64 give
    float64 (Q1's ``avg_qty``, Q20's ``0.5 * sq``).  Integer tensor operands
    are lifted to float64 in exactly those cases; numpy operands pass
    through untouched."""
    if op == "/" or (op in ("+", "-", "*") and
                     (isinstance(a, float) or isinstance(b, float))):
        a, b = lift_f64(a), lift_f64(b)
    return _BINOPS[op](a, b)


# ---------------------------------------------------------------------------
# compiled queries
# ---------------------------------------------------------------------------

class CompiledQuery:
    """A built-once logical plan, callable like the legacy ``query_fn(ctx)``.

    The plan is constructed lazily (first use) from ``build_fn`` and shared
    across calls; inference (:func:`analyze`) runs host-side once per
    database and is cached on the database object, so tracing a query twice
    never re-derives bounds.
    """

    def __init__(self, build_fn: Callable[[], P.Node], name: str | None = None):
        self._build_fn = build_fn
        self.name = name or getattr(build_fn, "__name__", "query")
        self._plan: P.Node | None = None

    @property
    def plan(self) -> P.Node:
        if self._plan is None:
            self._plan = self._build_fn()
        return self._plan

    # per-database PlanInfo cache bound: far above the 22 standing queries,
    # low enough that a process compiling throwaway queries per request
    # against one long-lived Database cannot grow without bound
    _INFO_CACHE_MAX = 256

    def info(self, db) -> PlanInfo:
        # keyed by id(self); the entry pins self so the id cannot be reused
        # by a later CompiledQuery while it is cached (FIFO-evicted at the
        # bound, which also unpins the evicted query)
        cache = db.__dict__.setdefault("_planinfo_cache", {})
        got = cache.get(id(self))
        if got is None or got[0] is not self:
            got = (self, analyze(self.plan, db))
            while len(cache) >= self._INFO_CACHE_MAX:
                cache.pop(next(iter(cache)))
            cache[id(self)] = got
        return got[1]

    def __call__(self, ctx):
        return self.run(ctx)

    def run(self, ctx, infer: bool | None = None,
            params: dict[str, Any] | None = None):
        if infer is None:
            infer = planner_default()
        info = self.info(ctx.db) if infer else None
        return _Executor(ctx, info, params=params).run(self.plan)

    def signature(self) -> str:
        """Content signature (:func:`plan_signature`) — cached: plans are
        immutable once built."""
        sig = self.__dict__.get("_signature")
        if sig is None:
            sig = self.__dict__["_signature"] = plan_signature(self.plan)
        return sig

    def params(self) -> dict[str, P.Param]:
        """Parameter placeholders of the plan (empty for literal queries)."""
        return params_of(self.plan)

    def with_inference(self, on: bool) -> "_PinnedQuery":
        """A ``query_fn(ctx)`` with the inference mode pinned (env-proof).

        Returns a wrapper that still exposes ``with_inference`` (and the
        plan/static introspection), so the fault runner's hint-drop recovery
        works on pinned queries too."""
        return _PinnedQuery(self, on)

    def approximate(self, db, den: int, seed: int | None = None,
                    min_rows: int | None = None, tables=None):
        """Sample-ladder rewrite of this plan onto rung ``1/den`` against
        ``db`` (``repro_torch.approx.rewrite``): the aggregation's scan moves
        onto a stratified sample with scale-up + CLT moment columns injected.
        Returns an ``ApproxRewrite`` or None when the shape is non-estimable
        (min/max, semi/anti-dependent counts, tiny domains) and must run
        exact."""
        from repro_torch.approx import rewrite as _ar  # approx imports us
        kwargs = {}
        if seed is not None:
            kwargs["seed"] = seed
        if min_rows is not None:
            kwargs["min_rows"] = min_rows
        return _ar.rewrite_for_rung(self, db, den, tables=tables, **kwargs)

    def static_counts(self) -> dict[str, int]:
        return static_plan_stats(self.plan)

    def static_wire(self, db, narrow: bool = True) -> list[dict]:
        """Per-exchange wire-byte descriptors from the IR (no execution);
        reuses the per-database PlanInfo cache."""
        return static_wire_stats(self.plan, db, narrow=narrow,
                                 info=self.info(db) if narrow else None)

    def validate(self, db) -> list[str]:
        return self.info(db).notes

    def explain(self, db) -> str:
        info = self.info(db)
        lines = [f"plan {self.name}: static exchanges {info.counts}"]
        for n in walk(self.plan):
            if isinstance(n, P.GroupBy):
                kb, gh = info.hints_for(n)
                if kb is not None:
                    path = "direct (sortless)"
                elif info.method_for(n) == "hash":
                    path = "hash (sortless dictionary)"
                else:
                    path = "single-sort"
                lines.append(
                    f"  group_by{list(n.keys)} exchange={n.exchange}: "
                    f"key_bits={list(kb) if kb else None} "
                    f"groups_hint={gh} -> {path}")
        for note in info.notes:
            lines.append(f"  NOTE: {note}")
        return "\n".join(lines)


def _direct_bits_max() -> int:
    from . import relational as rel     # deferred: relational imports the kernels
    return rel.DIRECT_AGG_BITS_MAX


def _hash_groups_max() -> int:
    from . import relational as rel     # deferred: relational imports the kernels
    return rel.HASH_AGG_GROUPS_MAX


class _PinnedQuery:
    """A CompiledQuery with the inference mode pinned; re-pinnable."""

    def __init__(self, query: CompiledQuery, infer: bool):
        self._query = query
        self._infer = infer

    def __call__(self, ctx):
        return self._query.run(ctx, infer=self._infer)

    def with_inference(self, on: bool) -> "_PinnedQuery":
        return _PinnedQuery(self._query, on)

    @property
    def plan(self) -> P.Node:
        return self._query.plan

    def static_counts(self) -> dict[str, int]:
        return self._query.static_counts()


def compile_query(build_fn: Callable[[], P.Node],
                  name: str | None = None) -> CompiledQuery:
    return CompiledQuery(build_fn, name)


# ---------------------------------------------------------------------------
# statistics-cache ownership (the only module that may touch these keys)
# ---------------------------------------------------------------------------

_INVALIDATION_HOOKS: list[Callable[[Any], None]] = []


def register_invalidation(hook: Callable[[Any], None]) -> None:
    """Register ``hook(db)`` to fire whenever :func:`invalidate_stats` drops
    a database's planner caches — the ONE doorway every stats-dependent cache
    above the planner (compiled-plan caches, serving templates) hangs off,
    so table mutation and ``stats_override`` entry/exit evict everywhere at
    once.  Idempotent per hook object; hooks must tolerate any ``db``."""
    if hook not in _INVALIDATION_HOOKS:
        _INVALIDATION_HOOKS.append(hook)


def invalidate_stats(db) -> None:
    """Drop the planner's caches on ``db`` (column stats + per-plan infos),
    then fire every registered invalidation hook.  For callers that mutate
    the database's tables, or benchmarks timing cold inference."""
    db.__dict__.pop("_plan_colstats", None)
    db.__dict__.pop("_planinfo_cache", None)
    for hook in list(_INVALIDATION_HOOKS):
        hook(db)


class stats_override:
    """Scoped replacement of ``db``'s column statistics (e.g. the SF=1000
    dry-run injecting modeled key domains).  Dependent PlanInfo caches are
    invalidated on entry AND exit, and the previous stats are restored, so
    executions after the scope re-infer at the database's actual scale."""

    def __init__(self, db, stats: dict[str, ColStats]):
        self.db = db
        self.stats = stats

    def __enter__(self):
        self._saved = self.db.__dict__.get("_plan_colstats")
        invalidate_stats(self.db)
        self.db.__dict__["_plan_colstats"] = self.stats
        return self.stats

    def __exit__(self, *exc):
        invalidate_stats(self.db)
        if self._saved is not None:
            self.db.__dict__["_plan_colstats"] = self._saved
        return False
