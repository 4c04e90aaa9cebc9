"""Planner pass: rewrite an aggregation plan onto a sample-ladder rung.

``rewrite_for_rung(query, db, den)`` looks for exactly one *rewrite site* —
a ``GroupBy`` or ``AggScalar`` whose input is a unary chain
(``Filter`` / ``Select`` / ``WithCol`` only) down to a ``Scan`` of a ladder
fact table — and rebuilds the DAG with

* the ``Scan`` retargeted onto the rung table (``<table>__r<den>``, built by
  :mod:`repro_torch.approx.sampling` stratified on the site's group keys);
* every estimable aggregate scale-up rewritten per
  :mod:`repro_torch.approx.estimators` (``sum(x)`` → ``sum(__sw * x)``,
  ``count`` → ``sum(__sw)``, ``avg`` untouched);
* CLT moment columns injected as ordinary aggregates (max/sum/count), so
  they ride the engine's partial-aggregate merges across every exchange.

It **refuses** — returns ``None``, meaning "run exact" — whenever the shape
is not estimable:

* any ``min`` / ``max`` aggregate at the site (an unsampled extreme is
  invisible; no CLT bar covers it);
* the chain from site to scan passes through a join/semi/anti/rename or any
  other non-unary operator (semi/anti-dependent counts cannot be scaled by a
  per-stratum weight);
* the site's output reaches the root through anything but projections and
  ``Finalize`` — a ``Filter`` (SQL HAVING), join, or expression consuming a
  scaled estimate would decide group membership / exact downstream results
  from an un-barred estimate (q18's ``sum_qty > 300`` is the canonical
  refusal);
* zero or multiple candidate sites, or the scan/chain is shared with another
  consumer (the sample would leak into non-aggregate outputs);
* the scanned table is too small (``min_rows``) — tiny inferred domains are
  cheaper exact than estimated;
* a group key that is not a raw integer column of the fact table (it could
  not have been a stratification key).

A ``Select`` between the site and the root (SQL lowering emits one whenever
the SELECT list reorders or omits GroupBy outputs) is rebuilt with the
moment columns appended, so the error-bar evidence is never projected away
between the site and :func:`repro_torch.approx.estimators.finalize_result`.

``den == 1`` is special-cased to a pure scan rename (the rung-1 "sample" is
the full table, row order preserved): no scale-up, no moment columns — the
plan is byte-identical to the exact one on every backend, which is the
differential identity leg ``tests/test_torch_approx.py`` pins.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import plan as P
from repro_torch.core import planner

from . import estimators as E
from . import sampling

__all__ = ["MIN_SAMPLE_ROWS", "ApproxRewrite", "rewrite_for_rung"]

# Below this row count the exact plan is already interactive — sampling would
# only add variance (ISSUE: "tiny inferred domains" refuse the rewrite).
MIN_SAMPLE_ROWS = 256

# Unary operators the site→scan chain may pass through.  Rename is excluded:
# it would detach the group keys from the stratification columns.
_CHAIN_OK = (P.Filter, P.Select, P.WithCol)


@dataclasses.dataclass
class ApproxRewrite:
    """A sample-rewritten query plus everything needed to run and finalize it."""

    query: "planner.CompiledQuery"   # the rewritten plan, compiled
    db: object                       # rung database (original tables + sample)
    den: int                         # ladder denominator (1 == full table)
    table: str                       # fact table that was sampled
    strata: tuple                    # stratification columns (the group keys)
    targets: tuple                   # (name, op) per estimable aggregate

    def finalize(self, cols, confidence: float = 0.95) -> E.ApproxEstimate:
        # den > 1 means the targets are scale-rewritten: finalize must find
        # the moment columns or raise — never serve an estimate as exact
        return E.finalize_result(cols, self.targets, confidence,
                                 scaled=self.den > 1)


def _default_tables():
    from repro_torch.data import tpch   # deferred: data layer is optional
    return tpch.FACT_TABLES


def _consumers(nodes):
    """node id -> number of distinct consuming edges (children + ScalarRefs)."""
    count: dict[int, int] = {}
    for n in nodes:
        for c in n.children:
            count[id(c)] = count.get(id(c), 0) + 1
        for e in planner._node_exprs(n):
            for sub in planner._expr_scalar_nodes(e):
                count[id(sub)] = count.get(id(sub), 0) + 1
    return count


def _find_site(root, db, tables, min_rows):
    """The unique (site, chain, scan) rewrite candidate, or None."""
    nodes = planner.walk(root)
    consumers = _consumers(nodes)
    candidates = []
    for site in nodes:
        if not isinstance(site, (P.GroupBy, P.AggScalar)):
            continue
        chain = []
        cur = site.children[0]
        while isinstance(cur, _CHAIN_OK):
            chain.append(cur)
            cur = cur.children[0]
        if not isinstance(cur, P.Scan):
            continue
        if cur.table not in tables or cur.table not in db.tables:
            continue
        t = db.tables[cur.table]
        n_rows = len(next(iter(t.values()))) if t else 0
        if n_rows < min_rows:
            continue
        # exclusivity: the scan and every chain node must feed only this
        # aggregation — a shared subtree would leak sample rows elsewhere
        if any(consumers.get(id(x), 0) != 1 for x in chain + [cur]):
            continue
        # an AggScalar estimate may only surface in the terminal
        # ScalarResult: feeding it into further computation (a filter
        # threshold, another aggregate) would poison exact downstream
        # results with an un-barred estimate
        if isinstance(site, P.AggScalar):
            refs = [n for n in nodes if any(
                site in planner._expr_scalar_nodes(e)
                for e in planner._node_exprs(n))]
            if refs != [root] or not isinstance(root, P.ScalarResult):
                continue
        candidates.append((site, tuple(chain), cur))
    if len(candidates) != 1:
        return None
    return candidates[0]


def _estimate_consumers(root, site):
    """Every node through which ``site``'s output flows on its way to the
    root — child edges and expression-embedded scalar references alike.
    ``site`` itself is excluded."""
    memo: dict[int, bool] = {}

    def reaches(n):
        got = memo.get(id(n))
        if got is not None:
            return got
        memo[id(n)] = False   # guard (plans are DAGs; cheap insurance)
        hit = any(c is site or reaches(c) for c in n.children)
        if not hit:
            for e in planner._node_exprs(n):
                if any(s is site or reaches(s)
                       for s in planner._expr_scalar_nodes(e)):
                    hit = True
                    break
        memo[id(n)] = hit
        return hit

    return [n for n in planner.walk(root) if n is not site and reaches(n)]


def _group_site_path_ok(consumers, site):
    """True iff a GroupBy site's scaled estimates reach the root only through
    non-computing nodes: projections (``Select``, key-only ``Rename``) and
    ``Finalize``.  A ``Filter`` (SQL HAVING), join, ``WithCol``, or any
    downstream aggregate would fold un-barred estimates into exact results —
    group membership decided by a point estimate is not covered by its CI —
    so such shapes refuse and run exact."""
    agg_names = {name for name, _, _ in site.aggs}
    for n in consumers:
        if isinstance(n, (P.Select, P.Finalize)):
            continue
        if isinstance(n, P.Rename) and not (set(n.mapping) & agg_names):
            continue
        return False
    return True


def _strata_for(site, scan_table, chain, db):
    """Group keys as stratification columns, or None if not raw fact columns."""
    keys = tuple(site.keys) if isinstance(site, P.GroupBy) else ()
    cols = db.tables[scan_table]
    import numpy as np
    for k in keys:
        v = cols.get(k)
        if v is None or np.asarray(v).dtype.kind not in "iu":
            return None
    # a WithCol on the chain redefining a key detaches it from the stratum
    for node in chain:
        if isinstance(node, P.WithCol) and any(k in node.exprs for k in keys):
            return None
    return keys


def _rebuild_expr(e, rebuild):
    """Copy an expression iff it embeds a rebuilt scalar sub-query."""
    if isinstance(e, P.ScalarRef):
        node = rebuild(e.node)
        return e if node is e.node else P.ScalarRef(node, e.name)
    if isinstance(e, P.BinOp):
        a, b = _rebuild_expr(e.a, rebuild), _rebuild_expr(e.b, rebuild)
        return e if a is e.a and b is e.b else P.BinOp(e.op, a, b)
    if isinstance(e, P.NotE):
        a = _rebuild_expr(e.a, rebuild)
        return e if a is e.a else P.NotE(a)
    if isinstance(e, P.Cast):
        a = _rebuild_expr(e.a, rebuild)
        return e if a is e.a else P.Cast(a, e.dtype)
    if isinstance(e, P.Year):
        a = _rebuild_expr(e.a, rebuild)
        return e if a is e.a else P.Year(a)
    if isinstance(e, P.Where):
        c = _rebuild_expr(e.cond, rebuild)
        a = _rebuild_expr(e.a, rebuild)
        b = _rebuild_expr(e.b, rebuild)
        return e if (c is e.cond and a is e.a and b is e.b) else P.Where(c, a, b)
    if isinstance(e, P.InSet):
        a = _rebuild_expr(e.a, rebuild)
        vals = tuple(_rebuild_expr(v, rebuild) for v in e.values)
        if a is e.a and all(x is y for x, y in zip(vals, e.values)):
            return e
        return P.InSet(a, vals)
    return e


def _scalar_targets(root, site, targets):
    """Remap AggScalar targets onto the terminal ScalarResult's output names.

    The site's aggregates carry internal names (SQL compilation emits
    ``__s0``-style slots); the answer columns are the ScalarResult's.  Only a
    *bare* ``ScalarRef`` is estimable — an estimate folded into arithmetic
    (a ratio of two aggregates, say) has no attachable error bar, so the
    rewrite refuses (returns None) and the query runs exact.
    """
    ops = dict(targets)
    out = []
    for k, e in root.exprs.items():
        if site not in planner._expr_scalar_nodes(e):
            continue
        if isinstance(e, P.ScalarRef) and e.node is site and e.name in ops:
            out.append((k, e.name, ops[e.name]))
        else:
            return None
    return tuple(out)


def _rewrite_aggs(aggs):
    """Scale-up + moment injection for one site's aggregate list.

    Returns ``(new_aggs, targets)`` or ``None`` when any aggregate is
    non-estimable.  The moment aggregates use only sum/max/count — ops the
    exchange layer already merges — so the error bars survive distribution.
    """
    wcol = P.col(P.SAMPLE_WEIGHT_COL)
    new_aggs, targets, moments = [], [], []
    for name, op, v in aggs:
        if op not in E.ESTIMABLE_OPS:
            return None
        ve = P.col(v) if isinstance(v, str) else v
        if op == "sum":
            new_aggs.append((name, "sum", wcol * ve))
        elif op == "count":
            new_aggs.append((name, "sum", wcol))
        else:  # avg: the plain sample mean is the estimator — unscaled
            new_aggs.append((name, op, v))
        targets.append((name, op))
        if op in ("sum", "avg"):
            moments.append((E.s1_col(name), "sum", ve))
            moments.append((E.s2_col(name), "sum", ve * ve))
    moments.append((E.N_COL, "max", P.col(P.SAMPLE_N_COL)))
    moments.append((E.M_COL, "max", P.col(P.SAMPLE_M_COL)))
    moments.append((E.MF_COL, "count", None))
    return tuple(new_aggs) + tuple(moments), tuple(targets)


def rewrite_for_rung(query, db, den, seed=sampling.DEFAULT_SEED,
                     min_rows=MIN_SAMPLE_ROWS, tables=None):
    """Rewrite ``query`` onto ladder rung ``1/den`` against ``db``.

    Returns an :class:`ApproxRewrite`, or ``None`` when the plan's shape is
    non-estimable and must run exact.  ``tables`` overrides the ladder fact
    tables (default: :data:`repro_torch.data.tpch.FACT_TABLES`).
    """
    den = int(den)
    if den not in sampling.LADDER:
        raise ValueError(f"den={den} not on the ladder {sampling.LADDER}")
    root = query.plan
    if tables is None:
        tables = _default_tables()
    found = _find_site(root, db, tuple(tables), min_rows)
    if found is None:
        return None
    site, chain, scan_node = found
    strata = _strata_for(site, scan_node.table, chain, db)
    if strata is None:
        return None
    consumer_select_ids: set[int] = set()
    moment_names: tuple = ()
    if den > 1:
        if isinstance(site, P.GroupBy):
            consumers = _estimate_consumers(root, site)
            if not _group_site_path_ok(consumers, site):
                return None
            consumer_select_ids = {id(n) for n in consumers
                                   if isinstance(n, P.Select)}
        rewritten = _rewrite_aggs(site.aggs)
        if rewritten is None:
            return None
        new_aggs, targets = rewritten
        moment_names = tuple(n for n, _, _ in new_aggs
                             if n.startswith(E.MOMENT_PREFIX))
    else:
        # rung 1 is the full table: keep the exact aggregate forms (and
        # dtypes) — byte-identity with the exact plan is a tested invariant
        new_aggs = site.aggs
        targets = tuple((name, op) for name, op, _ in site.aggs
                        if op in E.ESTIMABLE_OPS)
    scalar_map = None
    if isinstance(site, P.AggScalar):
        scalar_map = _scalar_targets(root, site, targets)
        if scalar_map is None:
            return None
        targets = tuple((k, op) for k, _, op in scalar_map)
    rdb = sampling.rung_database(db, scan_node.table, strata, den, seed)
    rname = sampling.rung_name(scan_node.table, den)
    chain_ids = {id(c) for c in chain}

    memo: dict[int, P.Node] = {}

    def rebuild(node):
        got = memo.get(id(node))
        if got is not None:
            return got
        new = _rebuild_node(node)
        memo[id(node)] = new
        return new

    def _rebuild_node(node):
        if node is scan_node:
            return P.Scan(rname)
        if id(node) in chain_ids:
            child = rebuild(node.children[0])
            if isinstance(node, P.Filter):
                return P.Filter(child, node.pred)
            if isinstance(node, P.WithCol):
                return P.WithCol(child, node.exprs)
            # Select on the sample chain must keep the bookkeeping columns
            # flowing into the site's scale-up/moment aggregates
            extra = () if den == 1 else tuple(
                c for c in (P.SAMPLE_WEIGHT_COL, P.SAMPLE_M_COL,
                            P.SAMPLE_N_COL) if c not in node.names)
            return P.Select(child, tuple(node.names) + extra)
        if node is site:
            child = rebuild(node.children[0])
            if isinstance(node, P.GroupBy):
                return child.group_by(node.keys, new_aggs,
                                      exchange=node.exchange, final=node.final,
                                      groups_hint=node.groups_hint)
            new_site = child.agg_scalar(new_aggs)
            return new_site
        if isinstance(node, P.Scan):
            return node       # a scan of some other (unsampled) table
        kids = tuple(rebuild(c) for c in node.children)
        same_kids = all(k is c for k, c in zip(kids, node.children))
        if isinstance(node, P.Filter):
            pred = _rebuild_expr(node.pred, rebuild)
            if same_kids and pred is node.pred:
                return node
            return P.Filter(kids[0], pred)
        if isinstance(node, P.Select):
            if id(node) in consumer_select_ids and moment_names:
                # a projection between the site and the root (SQL lowering
                # emits one when the SELECT list reorders or drops GroupBy
                # outputs) must keep the moment columns flowing to finalize
                extra = tuple(c for c in moment_names if c not in node.names)
                return P.Select(kids[0], tuple(node.names) + extra)
            return node if same_kids else P.Select(kids[0], node.names)
        if isinstance(node, P.WithCol):
            exprs = {k: _rebuild_expr(v, rebuild) for k, v in node.exprs.items()}
            if same_kids and all(exprs[k] is node.exprs[k] for k in exprs):
                return node
            return P.WithCol(kids[0], exprs)
        if isinstance(node, P.Rename):
            return node if same_kids else P.Rename(kids[0], node.mapping)
        if isinstance(node, P.Join):
            return node if same_kids else P.Join(
                kids[0], kids[1], node.on, node.build_on, node.take)
        if isinstance(node, P.Semi):
            return node if same_kids else P.Semi(
                kids[0], kids[1], node.on, node.build_on)
        if isinstance(node, P.Anti):
            return node if same_kids else P.Anti(
                kids[0], kids[1], node.on, node.build_on)
        if isinstance(node, P.Left):
            return node if same_kids else P.Left(
                kids[0], kids[1], node.on, node.build_on, node.take,
                node.defaults)
        if isinstance(node, P.GroupBy):
            aggs = tuple((n, op, _rebuild_expr(v, rebuild)
                          if isinstance(v, P.Expr) else v)
                         for n, op, v in node.aggs)
            if same_kids and all(a[2] is b[2]
                                 for a, b in zip(aggs, node.aggs)):
                return node
            return P.GroupBy(kids[0], node.keys, aggs, node.exchange,
                             node.final, node.groups_hint)
        if isinstance(node, P.AggScalar):
            aggs = tuple((n, op, _rebuild_expr(v, rebuild)
                          if isinstance(v, P.Expr) else v)
                         for n, op, v in node.aggs)
            if same_kids and all(a[2] is b[2]
                                 for a, b in zip(aggs, node.aggs)):
                return node
            return P.AggScalar(kids[0], aggs)
        if isinstance(node, P.Shuffle):
            return node if same_kids else P.Shuffle(kids[0], node.key)
        if isinstance(node, P.Broadcast):
            return node if same_kids else P.Broadcast(kids[0], node.p2p)
        if isinstance(node, P.Shrink):
            return node if same_kids else P.Shrink(kids[0], node.cap)
        if isinstance(node, P.Finalize):
            return node if same_kids else P.Finalize(
                kids[0], node.sort_keys, node.limit, node.replicated)
        if isinstance(node, P.ScalarResult):
            exprs = {k: _rebuild_expr(v, rebuild)
                     for k, v in node.exprs.items()}
            changed = any(exprs[k] is not node.exprs[k] for k in exprs)
            if not changed:
                return node
            # surface the injected moment scalars so finalize_result can
            # attach error bars to a scalar (AggScalar) answer; moments are
            # re-keyed from the site's internal agg slots onto the result's
            # output names (SQL compilation emits __s0-style slot names)
            if den > 1 and isinstance(site, P.AggScalar):
                new_site = memo[id(site)]
                for mcol in (E.N_COL, E.M_COL, E.MF_COL):
                    exprs[mcol] = P.ScalarRef(new_site, mcol)
                for out_name, agg_name, op in scalar_map:
                    if op in ("sum", "avg"):
                        exprs[E.s1_col(out_name)] = P.ScalarRef(
                            new_site, E.s1_col(agg_name))
                        exprs[E.s2_col(out_name)] = P.ScalarRef(
                            new_site, E.s2_col(agg_name))
            return P.ScalarResult(exprs)
        raise TypeError(f"unhandled plan node {type(node).__name__}")

    new_root = rebuild(root)
    name = getattr(query, "name", "query")
    compiled = planner.compile_query(lambda: new_root, name=f"{name}~r{den}")
    return ApproxRewrite(query=compiled, db=rdb, den=den,
                         table=scan_node.table, strata=strata,
                         targets=targets)
