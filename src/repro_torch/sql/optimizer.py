"""IR-to-IR optimizer: naive lowered plans -> budget-matching physical plans.

The passes transform the exchange-free output of
:mod:`repro_torch.sql.lower` into plans that pass ``planner.validate`` with
zero notes and hit the hand-built exchange / sort / wire budgets:

  1. **push** — predicate pushdown + semi/anti sinking.  Filters and
     membership constraints travel down through projections, renames, join
     probes, inner-join build sides and group-by keys until they sit on the
     scans (never into shared CTE subtrees).
  2. **merge** — adjacent Filter nodes collapse into one conjunction.
  3. **shared shuffle** — a group-by and a join that consume the same
     shared subtree on the same key get one Shuffle below the share point
     (TPC-H Q17's idiom), making the group-by local and the join
     co-partitioned at the cost of a single exchange.
  4. **pack** — multi-column group keys whose runtime method would be the
     sorted path (provable widths too wide for the direct path, domain too
     big for hash compaction) fold into one strided int64 key with
     ``max``-recovery aggregates, mirroring the hand plans' Q7/Q16 packing.
     The decision procedure replicates ``planner``'s hint inference exactly:
     packing is applied only where the planner would otherwise sort.
  5. **prune** — projection pruning: join takes narrow to consumed columns,
     unused aggregates and computed columns drop, scans grow a Select of
     exactly the required columns.
  6. **place** — exchange placement by the paper's §4.3/§4.4 rules:
     co-partitioned joins stay local; small builds broadcast (narrowed to
     the consumed columns); bounded probes broadcast against huge
     partitioned builds (Q18); single-key mismatches shuffle the probe;
     group-bys become local / gather+final / partial-shuffle by partition
     containment, membership-only consumption, and finality.
  7. **cse** — duplicate subtrees (same ``subplan_signatures`` hash) merge
     into one shared node.

Statistics are *static*: the catalog's scale-invariant domains plus
selectivity guesses over SF=1 cardinalities.  Estimates steer only
broadcast-vs-shuffle choices (always semantically sound either way); bound
claims (packing strides, narrow-wire widths) use invariant domains only, and
the engine re-checks every claimed bound at runtime via ``ctx.overflow``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import plan as P
from repro_torch.core import planner as PL

from . import catalog as C
from .ir import (clone_with, conjoin, conjuncts, expr_cols, output_columns,
                 rewrite, rewrite_expr, scalar_deps, walk)

__all__ = ["optimize"]

_BCAST = C.BCAST_MAX_ROWS
_GATHER_MAX = 1 << 17           # largest group count worth a final gather
REPL = PL.REPL


# ---------------------------------------------------------------------------
# static column statistics (db-free mirror of planner.ColStats inference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _St:
    """(lo, hi, card) with ``inv`` marking bounds that hold at every scale
    factor (the only bounds packing may rely on)."""
    lo: int | None = None
    hi: int | None = None
    card: int | None = None
    inv: bool = False

    def clamped(self) -> "_St":
        if self.lo is None or self.hi is None:
            return self
        width = max(0, int(self.hi) - int(self.lo) + 1)
        card = width if self.card is None else min(self.card, width)
        return _St(self.lo, self.hi, card, self.inv)


_UNK = _St()


def _scan_stats(table: str) -> dict[str, _St]:
    out = {}
    for cname, col in C.table_of(table).columns.items():
        if col.kind == "float":
            out[cname] = _UNK
        else:
            out[cname] = _St(col.lo, col.hi, None, col.invariant).clamped()
    return out


def _static_const(e):
    """Host-constant value when statically known (CodeLit codes are not)."""
    if isinstance(e, P.Lit):
        return e.value
    if isinstance(e, P.Param):
        return e.default
    if isinstance(e, P.DbScale):
        return 1.0
    if isinstance(e, P.Cast):
        return _static_const(e.a)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*", "/"):
        a, b = _static_const(e.a), _static_const(e.b)
        if a is None or b is None:
            return None
        if e.op == "/" and b == 0:
            return None
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[e.op]
    return None


def _const_range(e):
    """(lo, hi) over every admissible binding; Params use their domain."""
    if isinstance(e, P.Param):
        return None if e.lo is None else (e.lo, e.hi)
    if isinstance(e, (P.Lit, P.DbScale)):
        c = _static_const(e)
        return None if c is None else (c, c)
    if isinstance(e, P.Cast):
        return _const_range(e.a)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*"):
        a, b = _const_range(e.a), _const_range(e.b)
        if a is None or b is None:
            return None
        if e.op == "+":
            return (a[0] + b[0], a[1] + b[1])
        if e.op == "-":
            return (a[0] - b[1], a[1] - b[0])
        ps = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
        return (min(ps), max(ps))
    return None


def _expr_st(e, sch: dict) -> _St:
    if isinstance(e, P.Col):
        return sch.get(e.name, _UNK)
    if isinstance(e, P.Lit):
        if isinstance(e.value, bool) or not isinstance(e.value, int):
            return _UNK
        return _St(e.value, e.value, 1, True)
    if isinstance(e, P.CodeLit):
        col = C.column_table(e.col)
        size = C.table_of(col).columns[e.col].hi if col else None
        return _St(0, size, 1, True) if size is not None else _UNK
    if isinstance(e, P.Param):
        if e.dtype == "int64" and e.lo is not None:
            return _St(int(math.ceil(e.lo)), int(math.floor(e.hi)),
                       1, True).clamped()
        return _UNK
    if isinstance(e, P.Cast):
        return _expr_st(e.a, sch)
    if isinstance(e, P.BinOp) and e.op in ("+", "-", "*"):
        a, b = _expr_st(e.a, sch), _expr_st(e.b, sch)
        if None in (a.lo, a.hi, b.lo, b.hi):
            return _UNK
        if e.op == "+":
            lo, hi = a.lo + b.lo, a.hi + b.hi
        elif e.op == "-":
            lo, hi = a.lo - b.hi, a.hi - b.lo
        else:
            ps = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
            lo, hi = min(ps), max(ps)
        card = None if (a.card is None or b.card is None) else a.card * b.card
        return _St(lo, hi, card, a.inv and b.inv).clamped()
    if isinstance(e, P.Year):
        a = _expr_st(e.a, sch)
        if a.lo is None or a.hi is None:
            return _UNK
        return _St(PL._year_of_day(a.lo), PL._year_of_day(a.hi), a.card,
                   a.inv).clamped()
    if isinstance(e, P.Where):
        a, b = _expr_st(e.a, sch), _expr_st(e.b, sch)
        if None in (a.lo, a.hi, b.lo, b.hi):
            return _UNK
        card = None if (a.card is None or b.card is None) else a.card + b.card
        return _St(min(a.lo, b.lo), max(a.hi, b.hi), card,
                   a.inv and b.inv).clamped()
    if isinstance(e, P.AlphaRank):
        col = C.column_table(e.col)
        size = C.table_of(col).columns[e.col].hi if col else None
        return _St(0, size, None, True).clamped() if size is not None \
            else _UNK
    return _UNK


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _refine(pred, sch: dict) -> dict:
    """Static mirror of ``planner._refine_filter`` (CodeLit values unknown:
    they refine cardinality via InSet but never bounds)."""
    out = dict(sch)

    def _mn(a, b):
        return b if a is None else (a if b is None else min(a, b))

    def _mx(a, b):
        return b if a is None else (a if b is None else max(a, b))

    def apply(name, op, rng):
        s = out.get(name)
        if s is None or rng is None:
            return
        clo, chi = rng
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in (clo, chi)):
            return
        lo, hi, card = s.lo, s.hi, s.card
        if op == "<=":
            hi = _mn(hi, math.floor(chi))
        elif op == "<":
            hi = _mn(hi, math.ceil(chi) - 1)
        elif op == ">=":
            lo = _mx(lo, math.ceil(clo))
        elif op == ">":
            lo = _mx(lo, math.floor(clo) + 1)
        elif op == "==":
            lo = _mx(lo, math.ceil(clo))
            hi = _mn(hi, math.floor(chi))
            if lo is not None and hi is not None:
                card = _mn(card, max(1, hi - lo + 1))
        # a literal refinement is invariant on the refined side; keep the
        # conservative flag: invariant only if BOTH bounds now are
        inv = s.inv or (op == "==" and lo is not None and hi is not None)
        out[name] = _St(lo, hi, card, inv if op == "==" else s.inv).clamped()

    def visit(e):
        if isinstance(e, P.BinOp) and e.op == "&":
            visit(e.a)
            visit(e.b)
        elif isinstance(e, P.BinOp) and e.op in _FLIP:
            if isinstance(e.a, P.Col):
                apply(e.a.name, e.op, _const_range(e.b))
            elif isinstance(e.b, P.Col):
                apply(e.b.name, _FLIP[e.op], _const_range(e.a))
        elif isinstance(e, P.InSet) and isinstance(e.a, P.Col):
            s = out.get(e.a.name)
            vals = [_static_const(v) for v in e.values]
            if s is not None:
                k = len(e.values)
                if all(isinstance(v, int) and not isinstance(v, bool)
                       for v in vals):
                    lo = _mx(s.lo, min(vals))
                    hi = _mn(s.hi, max(vals))
                    out[e.a.name] = _St(lo, hi, _mn(s.card, k),
                                        s.inv).clamped()
                else:
                    out[e.a.name] = _St(s.lo, s.hi, _mn(s.card, k), s.inv)

    visit(pred)
    return out


class _Ctx:
    """Per-tree memoized schema / row-estimate / cap / consumer context."""

    def __init__(self, root):
        self.nodes = walk(root)
        self.consumers: dict[int, list] = {}
        for n in self.nodes:
            for i, ch in enumerate(n.children):
                self.consumers.setdefault(id(ch), []).append((n, i))
            for d in scalar_deps(n):
                self.consumers.setdefault(id(d), []).append((n, -1))
        self._sch: dict[int, dict] = {}
        self._est: dict[int, float] = {}

    # -- schema ------------------------------------------------------------
    def schema(self, n) -> dict:
        got = self._sch.get(id(n))
        if got is not None:
            return got
        if isinstance(n, P.Scan):
            s = _scan_stats(n.table)
        elif isinstance(n, P.Filter):
            s = _refine(n.pred, self.schema(n.children[0]))
        elif isinstance(n, P.Select):
            ch = self.schema(n.children[0])
            s = {c: ch[c] for c in n.names if c in ch}
        elif isinstance(n, P.WithCol):
            s = dict(self.schema(n.children[0]))
            for name, e in n.exprs.items():
                s[name] = _expr_st(e, s)
        elif isinstance(n, P.Rename):
            s = {n.mapping.get(c, c): v
                 for c, v in self.schema(n.children[0]).items()}
        elif isinstance(n, (P.Join, P.Left)):
            s = dict(self.schema(n.children[0]))
            bs = self.schema(n.children[1])
            for c in n.take:
                s[c] = bs.get(c, _UNK)
        elif isinstance(n, (P.Semi, P.Anti)):
            s = dict(self.schema(n.children[0]))
        elif isinstance(n, P.GroupBy):
            ch = self.schema(n.children[0])
            s = {k: ch.get(k, _UNK) for k in n.keys}
            for name, op, v in n.aggs:
                if op in ("min", "max"):
                    s[name] = ch.get(v, _UNK) if isinstance(v, str) else (
                        _expr_st(v, ch) if isinstance(v, P.Expr) else _UNK)
                elif op == "count":
                    s[name] = _St(0, None, None)
                else:
                    s[name] = _UNK
        elif isinstance(n, (P.Shuffle, P.Broadcast, P.Shrink, P.Finalize)):
            s = self.schema(n.children[0])
        else:
            s = {}
        self._sch[id(n)] = s
        return s

    # -- row estimates (SF=1; steer broadcast choices only) ----------------
    def keyspace(self, build, build_on) -> float:
        cols = (build_on,) if isinstance(build_on, str) else tuple(build_on)
        sch = self.schema(build)
        out = 1.0
        for c in cols:
            card = sch.get(c, _UNK).card
            out *= card if card else 1e9
        return out

    def selectivity(self, pred, sch: dict) -> float:
        sel = 1.0
        for c in conjuncts(pred):
            sel *= self._sel1(c, sch)
        return sel

    def _sel1(self, e, sch) -> float:
        if isinstance(e, P.NotE):
            return max(0.0, 1.0 - self._sel1(e.a, sch))
        if isinstance(e, P.BinOp) and e.op == "|":
            return min(1.0, self._sel1(e.a, sch) + self._sel1(e.b, sch))
        if isinstance(e, P.BinOp) and e.op == "&":
            return self._sel1(e.a, sch) * self._sel1(e.b, sch)
        if isinstance(e, (P.Like, P.StartsWith, P.EndsWith)):
            return 0.1
        if isinstance(e, P.InSet) and isinstance(e.a, P.Col):
            s = sch.get(e.a.name, _UNK)
            dom = s.card if s.card else 50
            return min(1.0, len(e.values) / dom)
        if isinstance(e, P.BinOp) and e.op in _FLIP:
            col, other, op = None, None, e.op
            if isinstance(e.a, P.Col):
                col, other = e.a, e.b
            elif isinstance(e.b, P.Col):
                col, other, op = e.b, e.a, _FLIP[e.op]
            if col is None:
                return 0.3
            s = sch.get(col.name, _UNK)
            if op == "==":
                if isinstance(other, P.CodeLit):
                    tab = C.column_table(other.col)
                    size = C.table_of(tab).columns[other.col].hi + 1
                    return 1.0 / size
                return 1.0 / s.card if s.card else 0.1
            c = _static_const(other)
            if c is None or s.lo is None or s.hi is None or s.hi <= s.lo:
                return 0.3
            span = s.hi - s.lo
            if op in ("<", "<="):
                return min(1.0, max(0.0, (c - s.lo) / span))
            return min(1.0, max(0.0, (s.hi - c) / span))
        return 0.3

    def est(self, n) -> float:
        got = self._est.get(id(n))
        if got is not None:
            return got
        if isinstance(n, P.Scan):
            r = float(C.table_of(n.table).rows)
        elif isinstance(n, P.Filter):
            r = self.est(n.children[0]) * self.selectivity(
                n.pred, self.schema(n.children[0]))
        elif isinstance(n, (P.Select, P.Rename, P.WithCol, P.Shuffle,
                            P.Broadcast, P.Finalize)):
            r = self.est(n.children[0])
        elif isinstance(n, P.Shrink):
            r = min(self.est(n.children[0]), float(n.cap))
        elif isinstance(n, (P.Join, P.Semi)):
            ks = self.keyspace(n.children[1], n.build_on)
            r = self.est(n.children[0]) * min(
                1.0, self.est(n.children[1]) / ks)
        elif isinstance(n, (P.Anti, P.Left)):
            r = self.est(n.children[0])
        elif isinstance(n, P.GroupBy):
            r = self.est(n.children[0])
            sch = self.schema(n.children[0])
            dom = 1.0
            for k in n.keys:
                card = sch.get(k, _UNK).card
                dom *= card if card else 1e9
            r = min(r, dom)
            if n.groups_hint is not None:
                r = min(r, float(n.groups_hint))
        else:
            r = self.est(n.children[0]) if n.children else 0.0
        self._est[id(n)] = r
        return r

    def cap(self, n):
        """Provable row cap (Shrink claims only — never estimates)."""
        if isinstance(n, P.Shrink):
            return n.cap
        if isinstance(n, (P.Filter, P.Select, P.WithCol, P.Rename, P.Semi,
                          P.Anti, P.Shuffle, P.Broadcast)):
            return self.cap(n.children[0])
        if isinstance(n, (P.Join, P.Left)):
            bon = n.on_pairs()[0][1]
            build = n.children[1]
            uniq = len(n.on_pairs()) == 1 and self._unique_on(build, bon)
            if uniq or isinstance(n, P.Left):
                return self.cap(n.children[0])
            return None
        return None

    def _unique_on(self, n, col) -> bool:
        if isinstance(n, P.Scan):
            return col in C.table_of(n.table).unique
        if isinstance(n, (P.Filter, P.Select, P.Shrink, P.Semi, P.Anti,
                          P.Broadcast, P.Shuffle, P.WithCol)):
            return self._unique_on(n.children[0], col)
        if isinstance(n, P.Rename):
            inv = {v: k for k, v in n.mapping.items()}
            return self._unique_on(n.children[0], inv.get(col, col))
        if isinstance(n, P.GroupBy):
            return len(n.keys) == 1 and n.keys[0] == col
        return False

    def membership_only(self, n) -> bool:
        for parent, role in self.consumers.get(id(n), []):
            if isinstance(parent, (P.Select, P.Rename, P.Broadcast)):
                if not self.membership_only(parent):
                    return False
            elif isinstance(parent, (P.Semi, P.Anti)) and role == 1:
                continue
            else:
                return False
        return bool(self.consumers.get(id(n)))

    def final_chain(self, n) -> bool:
        """True when every consumer path reaches Finalize through per-row
        operators only (the group-by's output is the query result)."""
        cons = self.consumers.get(id(n), [])
        if not cons:
            return False
        for parent, _role in cons:
            if isinstance(parent, P.Finalize):
                continue
            if isinstance(parent, (P.Filter, P.WithCol, P.Select, P.Rename,
                                   P.Shrink)) and self.final_chain(parent):
                continue
            return False
        return True


# ---------------------------------------------------------------------------
# pass 1+2: predicate pushdown, semi/anti sinking, filter merging
# ---------------------------------------------------------------------------

def _item_cols(it) -> set:
    if it[0] == "f":
        return expr_cols(it[1])
    on = it[2]
    return set(on) if isinstance(on, tuple) else {on}


class _Push:
    def __init__(self, root):
        self.ctx = _Ctx(root)
        self.memo: dict[int, object] = {}

    def shared(self, n) -> bool:
        return len(self.ctx.consumers.get(id(n), ())) > 1

    def run(self, n):
        got = self.memo.get(id(n))
        if got is None:
            got = self.push(n, [])
            self.memo[id(n)] = got
        return got

    def child(self, n, pending):
        if not pending:
            return self.run(n)
        if self.shared(n):
            return self.deposit(self.run(n), pending)
        return self.push(n, pending)

    def deposit(self, node, items):
        for it in items:
            if it[0] == "f":
                node = P.Filter(node, it[1])
            else:
                _, cls, on, bon, build = it
                node = cls(node, build, on, bon)
        return node

    def fix_expr(self, e):
        stack, refs = [e], []
        while stack:
            x = stack.pop()
            if isinstance(x, P.ScalarRef):
                refs.append(x.node)
            else:
                from .ir import expr_refs
                stack.extend(expr_refs(x))
        for dep in refs:
            self.run(dep)
        return rewrite_expr(e, None, self.memo)

    def push(self, n, pending):
        if isinstance(n, P.Filter):
            pred = self.fix_expr(n.pred)
            items = [("f", c) for c in conjuncts(pred)]
            return self.child(n.children[0], items + pending)
        if isinstance(n, (P.Semi, P.Anti)):
            build = self.run(n.build)
            item = ("s", type(n), n.on, n.build_on, build)
            return self.child(n.probe, [item] + pending)
        if isinstance(n, (P.Select, P.Shrink)):
            c = self.child(n.children[0], pending)
            return clone_with(n, (c,), self.memo)
        if isinstance(n, P.WithCol):
            new = set(n.exprs)
            passable = [it for it in pending if not (_item_cols(it) & new)]
            stuck = [it for it in pending if _item_cols(it) & new]
            c = self.child(n.children[0], passable)
            node = clone_with(n, (c,), self.memo)
            return self.deposit(node, stuck)
        if isinstance(n, P.Rename):
            inv = {v: k for k, v in n.mapping.items()}
            mapped = []
            for it in pending:
                if it[0] == "f":
                    mapped.append(("f", rewrite_expr(
                        it[1], lambda c: inv.get(c, c), self.memo)))
                else:
                    _, cls, on, bon, build = it
                    on2 = tuple(inv.get(c, c) for c in on) \
                        if isinstance(on, tuple) else inv.get(on, on)
                    mapped.append(("s", cls, on2, bon, build))
            c = self.child(n.children[0], mapped)
            return clone_with(n, (c,), self.memo)
        if isinstance(n, (P.Join, P.Left)):
            probe_out = set(output_columns(n.probe))
            take = set(n.take)
            probe_items, build_items, stuck = [], [], []
            for it in pending:
                cols = _item_cols(it)
                if cols and cols <= probe_out:
                    probe_items.append(it)
                elif cols and isinstance(n, P.Join) and cols <= take:
                    build_items.append(it)
                else:
                    stuck.append(it)
            p = self.child(n.probe, probe_items)
            b = self.child(n.build, build_items)
            node = clone_with(n, (p, b), self.memo)
            return self.deposit(node, stuck)
        if isinstance(n, P.GroupBy):
            keys = set(n.keys)
            passable = [it for it in pending if _item_cols(it) and
                        _item_cols(it) <= keys]
            stuck = [it for it in pending if it not in passable]
            c = self.child(n.children[0], passable)
            node = clone_with(n, (c,), self.memo)
            return self.deposit(node, stuck)
        # Scan / AggScalar / Finalize / ScalarResult / exchanges: barrier
        for d in scalar_deps(n):
            self.run(d)
        children = tuple(self.run(c) for c in n.children)
        node = clone_with(n, children, self.memo)
        return self.deposit(node, pending)


def _merge_filters(root):
    def fn(n):
        if isinstance(n, P.Filter) and isinstance(n.children[0], P.Filter):
            inner = n.children[0]
            return P.Filter(inner.children[0],
                            conjoin(conjuncts(inner.pred) +
                                    conjuncts(n.pred)))
        return n
    out = root
    while True:
        new = rewrite(out, fn)
        if new is out:
            return out
        out = new


# ---------------------------------------------------------------------------
# pass 3: shared shuffle (Q17)
# ---------------------------------------------------------------------------

def _shared_shuffle(root):
    ctx = _Ctx(root)
    for n in ctx.nodes:
        if not isinstance(n, P.GroupBy) or len(n.keys) != 1 or \
                n.exchange != "local":
            continue
        k = n.keys[0]
        x = n.children[0]
        cons = ctx.consumers.get(id(x), [])
        if len(cons) < 2:
            continue
        part = _static_part(x)
        if part == REPL or (isinstance(part, tuple) and set(part) <= {k}):
            continue
        join_probe = any(isinstance(p, (P.Join, P.Left)) and role == 0 and
                         any(pc == k for pc, _ in p.on_pairs())
                         for p, role in cons)
        if not join_probe:
            continue
        shuf = P.Shuffle(x, k)

        def fn(m, _x=x, _s=shuf):
            return _s if m is _x else m
        return rewrite(root, fn)
    return root


def _static_part(n):
    """Partitioning of a pre-placement subtree (mirrors planner.part)."""
    if isinstance(n, P.Scan):
        k = C.PARTITION.get(n.table)
        return REPL if k is None else (k,)
    if isinstance(n, (P.Filter, P.Select, P.Shrink)):
        return _static_part(n.children[0])
    if isinstance(n, P.WithCol):
        p = _static_part(n.children[0])
        if isinstance(p, tuple) and any(c in n.exprs for c in p):
            return None
        return p
    if isinstance(n, P.Rename):
        p = _static_part(n.children[0])
        if isinstance(p, tuple):
            return tuple(n.mapping.get(c, c) for c in p)
        return p
    if isinstance(n, P.Shuffle):
        return (n.key,)
    if isinstance(n, P.Broadcast):
        return REPL
    if isinstance(n, (P.Join, P.Left, P.Semi, P.Anti)):
        pp = _static_part(n.children[0])
        bp = _static_part(n.children[1])
        if pp is None or bp is None:
            return pp
        if bp == REPL:
            return pp
        if pp == REPL:
            if isinstance(n, P.Join):
                return _translate(bp, n.on_pairs())
            return None
        return pp
    if isinstance(n, P.GroupBy):
        if n.exchange == "local":
            return _static_part(n.children[0])
        if n.exchange == "shuffle":
            return tuple(n.keys)
        return REPL
    return None


def _translate(build_part, pairs):
    m = {b: pr for pr, b in pairs}
    if all(c in m for c in build_part):
        return tuple(m[c] for c in build_part)
    return None


# ---------------------------------------------------------------------------
# pass 4: group-key packing
# ---------------------------------------------------------------------------

def _would_sort(keys, sch, groups_hint) -> bool:
    """Mirror of planner hint inference: True when the runtime method for
    these keys would be the sorted path."""
    bits, card = [], 1
    for k in keys:
        s = sch.get(k, _UNK)
        if bits is not None and s.lo is not None and s.lo >= 0 \
                and s.hi is not None:
            bits.append(max(1, int(s.hi).bit_length()))
        else:
            bits = None
        card = None if (card is None or s.card is None) else card * s.card
    if bits is not None and sum(bits) <= PL._direct_bits_max():
        return False                                    # direct path
    gh = card
    if groups_hint is not None:
        gh = groups_hint if gh is None else min(gh, groups_hint)
    if gh is not None and gh <= PL._hash_groups_max() and \
            1 <= len(keys) <= 2:
        return False                                    # hash compaction
    return True


def _pack_wins(keys, sch, groups_hint):
    """The packed key when packing strictly improves on the unpacked
    method, else None.  Packing wins when it unlocks the DIRECT path the
    unpacked keys cannot prove (the direct path's static widths beat the
    hash path's trace-time dictionary — Q9: nationkey x year packs into
    9 bits where the raw columns need 16), or failing that, when the
    unpacked keys would take the sorted path at all."""
    bits = []
    for k in keys:
        s = sch.get(k, _UNK)
        if bits is not None and s.lo is not None and s.lo >= 0 \
                and s.hi is not None:
            bits.append(max(1, int(s.hi).bit_length()))
        else:
            bits = None
    if bits is not None and sum(bits) <= PL._direct_bits_max():
        return None                 # already direct without packing
    grp, hi = _pack_expr(keys, sch)
    if grp is None:
        return None                 # unprovable domain (Q13) — can't pack
    if hi.bit_length() <= PL._direct_bits_max():
        return grp                  # pack unlocks the direct path
    if _would_sort(keys, sch, groups_hint):
        return grp                  # pack at least collapses the sort
    return None                     # hash path is already sortless


def _pack_expr(keys, sch):
    """Strided int64 key over invariant domains; None when any key's bounds
    are not provable at every scale."""
    spans = []
    for k in keys:
        s = sch.get(k, _UNK)
        if not s.inv or s.lo is None or s.hi is None:
            return None, None
        spans.append((s.lo, s.hi - s.lo + 1))
    acc = P.Cast(P.Col(keys[0]), "int64")
    lo0, span0 = spans[0]
    if lo0:
        acc = P.BinOp("-", acc, P.Lit(lo0))
    hi = span0 - 1
    for k, (lo, span) in zip(keys[1:], spans[1:]):
        term = P.Col(k)
        if lo:
            term = P.BinOp("-", term, P.Lit(lo))
        acc = P.BinOp("+", P.BinOp("*", acc, P.Lit(span)), term)
        hi = hi * span + span - 1
    return acc, hi


def _pack_groups(root):
    ctx = _Ctx(root)

    def eligible(n):
        return (isinstance(n, P.GroupBy) and len(n.keys) >= 2 and
                n.exchange == "local")

    def fn(n):
        if not eligible(n):
            return n
        # nested dedup (Q16): this is the OUTER group-by over an inner
        # dedup group-by on a key superset — pack the shared subset once
        inner = n.children[0]
        if eligible(inner) and set(n.keys) < set(inner.keys) and \
                len(ctx.consumers.get(id(inner), [])) == 1:
            sch = ctx.schema(inner.children[0])
            grp = _pack_wins(n.keys, sch, n.groups_hint)
            if grp is None:
                return n
            packed = tuple(n.keys)
            rest = tuple(k for k in inner.keys if k not in packed)
            rec = tuple((k, "max", k) for k in packed)
            wc = P.WithCol(inner.children[0], {"__grp": grp})
            inner2 = P.GroupBy(wc, ("__grp",) + rest, inner.aggs + rec,
                               "local", False, inner.groups_hint)
            outer = P.GroupBy(inner2, ("__grp",), n.aggs + rec, "local",
                              False, n.groups_hint)
            return P.Select(outer, output_columns(n))
        if not ctx.final_chain(n):
            return n
        sch = ctx.schema(n.children[0])
        grp = _pack_wins(n.keys, sch, n.groups_hint)
        if grp is None:
            return n
        rec = tuple((k, "max", k) for k in n.keys)
        wc = P.WithCol(n.children[0], {"__grp": grp})
        gb = P.GroupBy(wc, ("__grp",), n.aggs + rec, "local", False,
                       n.groups_hint)
        return P.Select(gb, output_columns(n))

    return rewrite(root, fn)


# ---------------------------------------------------------------------------
# pass 5: projection pruning
# ---------------------------------------------------------------------------

def _required(ctx: _Ctx) -> dict:
    """Per-node required output columns, flowed root-to-leaves."""
    req: dict[int, set] = {}

    def need(n, cols):
        req.setdefault(id(n), set()).update(cols)

    for n in reversed(ctx.nodes):
        r = req.get(id(n), set())
        if isinstance(n, (P.Finalize, P.ScalarResult, P.AggScalar)) or \
                not ctx.consumers.get(id(n)):
            r = set(output_columns(n.children[0])) \
                if isinstance(n, P.Finalize) else r
            if isinstance(n, P.Finalize):
                req[id(n)] = set(r)
        if isinstance(n, P.Finalize):
            need(n.children[0], req[id(n)])
        elif isinstance(n, P.ScalarResult):
            pass                    # ScalarRef deps seed AggScalar below
        elif isinstance(n, P.AggScalar):
            cols = set()
            for _name, _op, v in n.aggs:
                if isinstance(v, P.Expr):
                    cols |= expr_cols(v)
                elif isinstance(v, str):
                    cols.add(v)
            need(n.children[0], cols)
        elif isinstance(n, P.Filter):
            need(n.children[0], r | expr_cols(n.pred))
        elif isinstance(n, P.Select):
            need(n.children[0], set(n.names))
        elif isinstance(n, P.WithCol):
            cols = set(r) - set(n.exprs)
            for name, e in n.exprs.items():
                if name in r:
                    cols |= expr_cols(e)
            need(n.children[0], cols)
        elif isinstance(n, P.Rename):
            inv = {v: k for k, v in n.mapping.items()}
            need(n.children[0], {inv.get(c, c) for c in r})
        elif isinstance(n, P.Shuffle):
            need(n.children[0], r | {n.key})
        elif isinstance(n, (P.Broadcast, P.Shrink)):
            need(n.children[0], r)
        elif isinstance(n, (P.Join, P.Left)):
            pairs = n.on_pairs()
            need(n.children[0], (r - set(n.take)) | {pc for pc, _ in pairs})
            need(n.children[1], (r & set(n.take)) | {bc for _, bc in pairs})
        elif isinstance(n, (P.Semi, P.Anti)):
            pairs = n.on_pairs()
            need(n.children[0], r | {pc for pc, _ in pairs})
            need(n.children[1], {bc for _, bc in pairs})
        elif isinstance(n, P.GroupBy):
            keep = [(name, op, v) for name, op, v in n.aggs
                    if name in r or not ctx.consumers.get(id(n))]
            cols = set(n.keys)
            for _name, op, v in keep:
                if isinstance(v, P.Expr):
                    cols |= expr_cols(v)
                elif isinstance(v, str):
                    cols.add(v)
            need(n.children[0], cols)
    return req


def _prune(root):
    ctx = _Ctx(root)
    req = _required(ctx)
    memo: dict[int, object] = {}

    def narrow(orig, n):
        # req is keyed by the ORIGINAL node's id; n is the rebuilt node
        r = req.get(id(orig))
        if isinstance(n, P.Scan) and r is not None:
            names = [c for c in output_columns(n) if c in r]
            if names and len(names) < len(output_columns(n)):
                return P.Select(n, names)
            return n
        if isinstance(n, (P.Join, P.Left)) and r is not None:
            take = tuple(c for c in n.take if c in r)
            if take == n.take:
                return n
            if isinstance(n, P.Left):
                defaults = {c: n.defaults[c] for c in take}
                return P.Left(n.children[0], n.children[1], n.on,
                              n.build_on, take, defaults)
            return P.Join(n.children[0], n.children[1], n.on, n.build_on,
                          take)
        if isinstance(n, P.GroupBy) and r is not None and \
                ctx.consumers.get(id(orig)):
            aggs = tuple(a for a in n.aggs if a[0] in r)
            if aggs != n.aggs and aggs:
                return P.GroupBy(n.children[0], n.keys, aggs, n.exchange,
                                 n.final, n.groups_hint)
            return n
        if isinstance(n, P.WithCol) and r is not None and \
                ctx.consumers.get(id(orig)):
            exprs = {k: v for k, v in n.exprs.items() if k in r}
            if not exprs:
                return n.children[0]
            if len(exprs) < len(n.exprs):
                return P.WithCol(n.children[0], exprs)
            return n
        return n

    def go(n):
        got = memo.get(id(n))
        if got is not None:
            return got
        for d in scalar_deps(n):
            go(d)
        children = tuple(go(c) for c in n.children)
        new = narrow(n, clone_with(n, children, memo))
        memo[id(n)] = new
        return new

    return go(root)


# ---------------------------------------------------------------------------
# pass 6: exchange placement
# ---------------------------------------------------------------------------

class _Place:
    def __init__(self, root):
        self.ctx = _Ctx(root)
        self.req = _required(self.ctx)
        self._part: dict[int, object] = {}

    def part(self, n):
        got = self._part.get(id(n), "_miss")
        if got == "_miss":
            got = self._derive(n)
            self._part[id(n)] = got
        return got

    def _derive(self, n):
        if isinstance(n, P.Scan):
            k = C.PARTITION.get(n.table)
            return REPL if k is None else (k,)
        if isinstance(n, (P.Filter, P.Select, P.Shrink)):
            return self.part(n.children[0])
        if isinstance(n, P.WithCol):
            p = self.part(n.children[0])
            if isinstance(p, tuple) and any(c in n.exprs for c in p):
                return None
            return p
        if isinstance(n, P.Rename):
            p = self.part(n.children[0])
            return tuple(n.mapping.get(c, c) for c in p) \
                if isinstance(p, tuple) else p
        if isinstance(n, P.Shuffle):
            return (n.key,)
        if isinstance(n, P.Broadcast):
            return REPL
        if isinstance(n, (P.Join, P.Left, P.Semi, P.Anti)):
            pp, bp = self.part(n.children[0]), self.part(n.children[1])
            pairs = n.on_pairs()
            if pp is None or bp is None:
                return pp
            if bp == REPL:
                return pp
            if pp == REPL:
                return _translate(bp, pairs) if isinstance(n, P.Join) \
                    else None
            if _translate(bp, pairs) == pp:
                return pp
            return pp
        if isinstance(n, P.GroupBy):
            if n.exchange == "local":
                return self.part(n.children[0])
            if n.exchange == "shuffle":
                return tuple(n.keys)
            return REPL
        return None

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _narrow(node, needed):
        out = output_columns(node)
        names = [c for c in out if c in needed]
        if len(names) < len(out):
            return P.Select(node, names)
        return node

    def _bcast_build(self, b, needed):
        return P.Broadcast(self._narrow(b, needed), False)

    @staticmethod
    def _gb_cols(n):
        """Columns a GroupBy reads: keys plus aggregate operands."""
        cols = set(n.keys)
        for _name, _op, v in n.aggs:
            if isinstance(v, P.Expr):
                cols |= expr_cols(v)
            elif isinstance(v, str):
                cols.add(v)
        return cols

    # -- join/semi placement ----------------------------------------------
    def join(self, orig, n):
        pairs = n.on_pairs()
        pp, bp = self.part(n.children[0]), self.part(n.children[1])
        if bp == REPL:
            return n
        if pp is not None and bp is not None and \
                _translate(bp, pairs) == pp:
            return n
        if pp == REPL and isinstance(n, P.Join) and bp is not None:
            return n                      # replicated probe, exact (Q18 tail)
        probe_o, build_o = orig.children
        if isinstance(n, (P.Semi, P.Anti)):
            bon = n.build_on
            needed = set(bon) if isinstance(bon, tuple) else {bon}
            if self.ctx.est(build_o) <= _BCAST:
                b = self._bcast_build(n.children[1], needed)
                return type(n)(n.children[0], b, n.on, n.build_on)
            # dedup to key membership, then broadcast or shuffle the keys
            cols = sorted(needed)
            sel = self._narrow(n.children[1], needed)
            if self.ctx.keyspace(build_o, n.build_on) <= _BCAST:
                g = P.GroupBy(sel, tuple(cols), (("__n", "count", None),),
                              "local", False, None)
                b = P.Broadcast(P.Select(g, cols), False)
                return type(n)(n.children[0], b, n.on, n.build_on)
            if len(cols) == 1:
                g = P.GroupBy(sel, tuple(cols), (("__n", "count", None),),
                              "shuffle", False, None)
                b = P.Select(g, cols)
                if _translate((cols[0],), pairs) == pp:
                    return type(n)(n.children[0], b, n.on, n.build_on)
                r = self.req.get(id(orig), set())
                p = self._narrow(n.children[0],
                                 r | {pc for pc, _ in pairs})
                return type(n)(P.Shuffle(p, pairs[0][0]), b,
                               n.on, n.build_on)
            return type(n)(n.children[0],
                           P.Broadcast(sel, False), n.on, n.build_on)
        # inner / left joins
        needed = set(n.take) | {bc for _, bc in pairs}
        if self.ctx.est(build_o) <= _BCAST:
            return self._rebuild_join(
                n, n.children[0], self._bcast_build(n.children[1], needed))
        cap = self.ctx.cap(probe_o)
        if isinstance(n, P.Join) and cap is not None and cap <= _BCAST \
                and bp is not None:
            return self._rebuild_join(n, P.Broadcast(n.children[0], False),
                                      n.children[1])
        r = self.req.get(id(orig), set())
        p_need = (r - set(n.take)) | {pc for pc, _ in pairs}
        b_need = (r & set(n.take)) | {bc for _, bc in pairs}
        if bp is not None and len(bp) == 1:
            t = _translate(bp, pairs)
            if t is not None:
                p = self._narrow(n.children[0], p_need)
                return self._rebuild_join(
                    n, P.Shuffle(p, t[0]), n.children[1])
        # generic fallback: co-partition both sides on the first pair
        pc, bc = pairs[0]
        return self._rebuild_join(
            n, P.Shuffle(self._narrow(n.children[0], p_need), pc),
            P.Shuffle(self._narrow(n.children[1], b_need), bc))

    @staticmethod
    def _rebuild_join(n, p, b):
        if isinstance(n, P.Left):
            return P.Left(p, b, n.on, n.build_on, n.take, n.defaults)
        return P.Join(p, b, n.on, n.build_on, n.take)

    def _feeds_join(self, orig):
        """Follow a sole-consumer Select/Rename chain from ``orig`` to a
        join build input; returns (join, {group key -> name at join})."""
        node, names = orig, {k: k for k in orig.keys}
        while True:
            cons = self.ctx.consumers.get(id(node), [])
            if len(cons) != 1:
                return None
            p, role = cons[0]
            if isinstance(p, P.Select):
                node = p
            elif isinstance(p, P.Rename):
                names = {k: p.mapping.get(v, v) for k, v in names.items()}
                node = p
            elif isinstance(p, (P.Join, P.Left, P.Semi, P.Anti)) and \
                    role == 1:
                return p, names
            else:
                return None

    # -- group-by placement -------------------------------------------------
    def groupby(self, orig, n):
        cp = self.part(n.children[0])
        keys = set(n.keys)
        if cp == REPL or (isinstance(cp, tuple) and set(cp) <= keys):
            return n
        if self.ctx.membership_only(orig):
            return n
        # nested dedup: sole consumer is a group-by on a key subset — one
        # shuffle on a shared key makes both local (Q16's composite dedup)
        cons = self.ctx.consumers.get(id(orig), [])
        if len(cons) == 1 and isinstance(cons[0][0], P.GroupBy):
            outer = cons[0][0]
            shared = [k for k in outer.keys if k in keys]
            if shared and set(outer.keys) < keys:
                sel = self._narrow(n.children[0], self._gb_cols(n))
                return P.GroupBy(P.Shuffle(sel, shared[0]),
                                 n.keys, n.aggs, "local", False,
                                 n.groups_hint)
        # feeding a join build: co-partition with the probe
        feed = self._feeds_join(orig)
        if feed is not None:
            parent, names = feed
            pp = _static_part(parent.children[0])
            pairs = parent.on_pairs()
            mapped = tuple(names[k] for k in n.keys)
            if pp is not None and _translate(mapped, pairs) == pp:
                return P.GroupBy(n.children[0], n.keys, n.aggs, "shuffle",
                                 False, n.groups_hint)
            inv = {v: k for k, v in names.items()}
            for pc, bc in pairs:
                if bc in inv and isinstance(pp, tuple) and pc in pp:
                    sel = self._narrow(n.children[0], self._gb_cols(n))
                    return P.GroupBy(P.Shuffle(sel, inv[bc]),
                                     n.keys, n.aggs, "local", False,
                                     n.groups_hint)
        if self.ctx.final_chain(orig):
            sch = self.ctx.schema(orig.children[0])
            dom = 1.0
            for k in n.keys:
                card = sch.get(k, _UNK).card
                dom *= card if card else float("inf")
            if n.groups_hint is not None:
                dom = min(dom, float(n.groups_hint))
            if dom <= _GATHER_MAX:
                return P.GroupBy(n.children[0], n.keys, n.aggs, "gather",
                                 True, n.groups_hint)
        return P.GroupBy(n.children[0], n.keys, n.aggs, "shuffle", False,
                         n.groups_hint)

    # -- driver --------------------------------------------------------------
    def run(self, root):
        memo: dict[int, object] = {}

        def go(n):
            got = memo.get(id(n))
            if got is not None:
                return got
            for d in scalar_deps(n):
                go(d)
            children = tuple(go(c) for c in n.children)
            new = clone_with(n, children, memo)
            if isinstance(new, (P.Join, P.Left, P.Semi, P.Anti)):
                new = self.join(n, new)
            elif isinstance(new, P.GroupBy) and new.exchange == "local":
                new = self.groupby(n, new)
            elif isinstance(new, P.Finalize):
                repl = self.part(new.children[0]) == REPL
                if repl != new.replicated:
                    new = P.Finalize(new.children[0], new.sort_keys,
                                     new.limit, repl)
            memo[id(n)] = new
            return new

        return go(root)


# ---------------------------------------------------------------------------
# pass 7: common-subplan elimination
# ---------------------------------------------------------------------------

def _cse(root):
    sigs = PL.subplan_signatures(root)
    by_sig: dict[tuple, object] = {}
    repl: dict[int, object] = {}
    for n in walk(root):
        sig = sigs.get(id(n))
        if sig is None:
            continue
        rep = by_sig.get(sig)
        if rep is None:
            by_sig[sig] = n
        elif rep is not n:
            repl[id(n)] = rep
    if not repl:
        return root

    def fn(n):
        return repl.get(id(n), n)
    # note: fn sees REBUILT nodes; map original ids by rewriting children
    # bottom-up — rebuilt duplicates keep their original id only when
    # untouched, so run to fixpoint on fresh signatures
    out = rewrite(root, fn)
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def optimize(root):
    """Run the full pass pipeline on a lowered plan root."""
    root = _Push(root).run(root)
    root = _merge_filters(root)
    root = _shared_shuffle(root)
    root = _pack_groups(root)
    root = _prune(root)
    root = _Place(root).run(root)
    for _ in range(3):
        new = _cse(root)
        if new is root:
            break
        root = new
    return root
