"""Plan-IR traversal and rebuild utilities for the optimizer passes.

`core/plan.py` nodes form an object-identity DAG (shared subtrees ARE the
same Python object, and scalar subqueries are referenced from *expressions*
via ``ScalarRef``).  Every rewrite here is identity-preserving: a node whose
children and expressions are unchanged is returned as-is, so untouched shared
subtrees stay shared and ``subplan_signatures``-based CSE remains valid.
"""
from __future__ import annotations

from typing import Callable, Iterable

from repro_torch.core import plan as P

__all__ = ["expr_refs", "expr_cols", "rewrite_expr", "node_exprs",
           "scalar_deps", "clone_with", "rewrite", "walk", "conjuncts",
           "conjoin", "output_columns"]


# ------------------------------------------------------------- expressions

def expr_refs(e) -> Iterable:
    """Direct sub-expressions of ``e``."""
    if isinstance(e, P.BinOp):
        return (e.a, e.b)
    if isinstance(e, (P.NotE, P.Year)):
        return (e.a,)
    if isinstance(e, P.Cast):
        return (e.a,)
    if isinstance(e, P.Where):
        return (e.cond, e.a, e.b)
    if isinstance(e, P.InSet):
        return (e.a,)
    return ()


def expr_cols(e) -> set[str]:
    """Input column names an expression reads (``CodeLit`` reads none — it
    is a dictionary-resolved constant)."""
    out: set[str] = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, P.Col):
            out.add(x.name)
        elif isinstance(x, (P.AlphaRank, P.Like, P.StartsWith, P.EndsWith)):
            out.add(x.col)
        else:
            stack.extend(expr_refs(x))
    return out


def _hints_of(e) -> dict:
    return getattr(e, "_sql_hints", None) or {}


def _carry_hints(new, old):
    h = _hints_of(old)
    if h and new is not old:
        new._sql_hints = dict(h)
    return new


def rewrite_expr(e, col_fn: Callable | None = None,
                 node_map: dict | None = None):
    """Rebuild ``e``; ``col_fn(name)`` may substitute column references
    (return an Expr or a new name), ``node_map`` redirects ``ScalarRef``
    targets.  Unchanged sub-expressions are returned as-is."""
    def sub(x):
        return rewrite_expr(x, col_fn, node_map)

    if isinstance(e, P.Col) and col_fn is not None:
        r = col_fn(e.name)
        if r is None or r is e.name:
            return e
        return P.Col(r) if isinstance(r, str) else r
    if isinstance(e, P.BinOp):
        a, b = sub(e.a), sub(e.b)
        if a is e.a and b is e.b:
            return e
        return _carry_hints(P.BinOp(e.op, a, b), e)
    if isinstance(e, P.NotE):
        a = sub(e.a)
        return e if a is e.a else _carry_hints(P.NotE(a), e)
    if isinstance(e, P.Cast):
        a = sub(e.a)
        return e if a is e.a else P.Cast(a, e.dtype)
    if isinstance(e, P.Year):
        a = sub(e.a)
        return e if a is e.a else P.Year(a)
    if isinstance(e, P.Where):
        c, a, b = sub(e.cond), sub(e.a), sub(e.b)
        if c is e.cond and a is e.a and b is e.b:
            return e
        return P.Where(c, a, b)
    if isinstance(e, P.InSet):
        a = sub(e.a)
        return e if a is e.a else _carry_hints(P.InSet(a, e.values), e)
    if isinstance(e, (P.AlphaRank, P.Like, P.StartsWith, P.EndsWith)) \
            and col_fn is not None:
        r = col_fn(e.col)
        if r is not None and isinstance(r, str) and r != e.col:
            if isinstance(e, P.AlphaRank):
                return P.AlphaRank(r)
            if isinstance(e, P.Like):
                return _carry_hints(P.Like(r, e.subs), e)
            if isinstance(e, P.StartsWith):
                return _carry_hints(P.StartsWith(r, e.prefix), e)
            return _carry_hints(P.EndsWith(r, e.suffix), e)
        return e
    if isinstance(e, P.ScalarRef) and node_map is not None:
        tgt = node_map.get(id(e.node))
        if tgt is not None and tgt is not e.node:
            return P.ScalarRef(tgt, e.name)
        return e
    return e


# ------------------------------------------------------------------ nodes

def node_exprs(n) -> list:
    """All expressions a node carries (preds, computed cols, agg values)."""
    if isinstance(n, P.Filter):
        return [n.pred]
    if isinstance(n, P.WithCol):
        return list(n.exprs.values())
    if isinstance(n, P.ScalarResult):
        return list(n.exprs.values())
    if isinstance(n, (P.GroupBy, P.AggScalar)):
        return [v for _, _, v in n.aggs if isinstance(v, P.Expr)]
    return []


def scalar_deps(n) -> list:
    """Plan nodes referenced from ``n``'s expressions via ``ScalarRef``."""
    deps = []
    for e in node_exprs(n):
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, P.ScalarRef):
                deps.append(x.node)
            else:
                stack.extend(expr_refs(x))
    return deps


def _sub_aggs(aggs, fix):
    out, changed = [], False
    for name, op, v in aggs:
        nv = fix(v) if isinstance(v, P.Expr) else v
        changed |= nv is not v
        out.append((name, op, nv))
    return tuple(out) if changed else aggs


def clone_with(n, children: tuple, node_map: dict | None = None):
    """Rebuild ``n`` with new children; expressions get their ``ScalarRef``
    targets redirected through ``node_map``.  Identity-preserving."""
    def fix(e):
        return rewrite_expr(e, None, node_map)

    if isinstance(n, P.Scan):
        return n
    if isinstance(n, P.Filter):
        pred = fix(n.pred)
        if children[0] is n.children[0] and pred is n.pred:
            return n
        return P.Filter(children[0], pred)
    if isinstance(n, P.Select):
        if children[0] is n.children[0]:
            return n
        return P.Select(children[0], n.names)
    if isinstance(n, P.WithCol):
        exprs = {k: fix(v) for k, v in n.exprs.items()}
        if children[0] is n.children[0] and \
                all(exprs[k] is n.exprs[k] for k in exprs):
            return n
        return P.WithCol(children[0], exprs)
    if isinstance(n, P.Rename):
        if children[0] is n.children[0]:
            return n
        return P.Rename(children[0], n.mapping)
    if isinstance(n, P.Join):
        if children == n.children:
            return n
        return P.Join(children[0], children[1], n.on, n.build_on, n.take)
    if isinstance(n, P.Semi):
        if children == n.children:
            return n
        return P.Semi(children[0], children[1], n.on, n.build_on)
    if isinstance(n, P.Anti):
        if children == n.children:
            return n
        return P.Anti(children[0], children[1], n.on, n.build_on)
    if isinstance(n, P.Left):
        if children == n.children:
            return n
        return P.Left(children[0], children[1], n.on, n.build_on, n.take,
                      n.defaults)
    if isinstance(n, P.GroupBy):
        aggs = _sub_aggs(n.aggs, fix)
        if children[0] is n.children[0] and aggs is n.aggs:
            return n
        return P.GroupBy(children[0], n.keys, aggs, n.exchange, n.final,
                         n.groups_hint)
    if isinstance(n, P.AggScalar):
        aggs = _sub_aggs(n.aggs, fix)
        if children[0] is n.children[0] and aggs is n.aggs:
            return n
        return P.AggScalar(children[0], aggs)
    if isinstance(n, P.Shuffle):
        if children[0] is n.children[0]:
            return n
        return P.Shuffle(children[0], n.key)
    if isinstance(n, P.Broadcast):
        if children[0] is n.children[0]:
            return n
        return P.Broadcast(children[0], n.p2p)
    if isinstance(n, P.Shrink):
        if children[0] is n.children[0]:
            return n
        return P.Shrink(children[0], n.cap)
    if isinstance(n, P.Finalize):
        if children[0] is n.children[0]:
            return n
        return P.Finalize(children[0], n.sort_keys, n.limit, n.replicated)
    if isinstance(n, P.ScalarResult):
        exprs = {k: fix(v) for k, v in n.exprs.items()}
        if all(exprs[k] is n.exprs[k] for k in exprs):
            return n
        return P.ScalarResult(exprs)
    raise TypeError(f"clone_with: unknown node {type(n).__name__}")


def rewrite(root, fn: Callable):
    """Bottom-up memoized rewrite.  ``fn(node)`` returns a replacement node
    (or the node itself); children and ``ScalarRef`` targets are already
    rewritten when ``fn`` sees the node.  Shared subtrees are visited once
    and stay shared."""
    memo: dict[int, object] = {}

    def go(n):
        hit = memo.get(id(n))
        if hit is not None:
            return hit
        for dep in scalar_deps(n):
            memo[id(dep)] = go(dep)
        new_children = tuple(go(c) for c in n.children)
        node_map = {i: v for i, v in memo.items()}
        rebuilt = clone_with(n, new_children, node_map)
        out = fn(rebuilt)
        memo[id(n)] = out
        return out

    return go(root)


def walk(root) -> list:
    """Post-order node list (children before parents), each node once."""
    seen: set[int] = set()
    out: list = []

    def go(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for dep in scalar_deps(n):
            go(dep)
        for c in n.children:
            go(c)
        out.append(n)

    go(root)
    return out


# ------------------------------------------------------------- predicates

def conjuncts(pred) -> list:
    """Split a predicate on top-level AND (``&``)."""
    if isinstance(pred, P.BinOp) and pred.op == "&":
        return conjuncts(pred.a) + conjuncts(pred.b)
    return [pred]


def conjoin(preds: list):
    out = preds[0]
    for p in preds[1:]:
        out = P.BinOp("&", out, p)
    return out


# ---------------------------------------------------------- output schema

def output_columns(n) -> list[str]:
    """Column names a node produces, in a deterministic order."""
    from . import catalog
    if isinstance(n, P.Scan):
        return list(catalog.table_of(n.table).columns)
    if isinstance(n, (P.Filter, P.Shuffle, P.Broadcast, P.Shrink)):
        return output_columns(n.children[0])
    if isinstance(n, P.Finalize):
        return output_columns(n.children[0])
    if isinstance(n, P.Select):
        return list(n.names)
    if isinstance(n, P.WithCol):
        base = output_columns(n.children[0])
        return base + [k for k in n.exprs if k not in base]
    if isinstance(n, P.Rename):
        return [n.mapping.get(c, c) for c in output_columns(n.children[0])]
    if isinstance(n, (P.Join, P.Left)):
        return output_columns(n.children[0]) + list(n.take)
    if isinstance(n, (P.Semi, P.Anti)):
        return output_columns(n.children[0])
    if isinstance(n, P.GroupBy):
        return list(n.keys) + [name for name, _, _ in n.aggs]
    raise TypeError(f"output_columns: unknown node {type(n).__name__}")
