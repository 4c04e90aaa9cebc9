"""AST -> naive logical plan lowering (the binder).

Produces a *correct but exchange-free* plan DAG from a parsed query: every
join is a plain hash join taking all build columns, every ``GroupBy`` is
``exchange="local"``, every ``Finalize`` is non-replicated.  The optimizer
(:mod:`repro_torch.sql.optimizer`) then sinks predicates, prunes columns, packs
group keys and places exchanges; lowering concentrates on *name resolution*
and *typing* against the static catalog.

Design points that matter downstream:

  * **CTEs lower once.**  ``WITH x AS (...)`` produces one plan node reused
    by every reference — the natural expression of the hand plans' shared
    sub-DAGs (Q2's ``j``, Q11's filtered partsupp, Q15's grouped partials),
    and what makes ``subplan_signatures``-based CSE mostly a no-op.
  * **Semi/anti stay relational.**  ``IN (SELECT ...)`` / ``EXISTS`` become
    ``Semi``/``Anti`` nodes immediately (never decorrelated joins), because
    the engine's membership joins are the cheap primitive.
  * **Functional-dependency key reduction.**  ``GROUP BY k, a, b`` where a
    unique-key join proves ``k -> a, b`` groups by ``k`` alone and recovers
    ``a``/``b`` as ``max`` aggregates (TPC-H Q3), matching the hand plans.
  * **Strings exist only against dictionary columns.**  A string literal
    binds as the dictionary *code* of the compared column
    (``P.CodeLit``); anything else is a type error at bind time.
"""
from __future__ import annotations

import dataclasses
import datetime

from repro_torch.core import plan as P
from repro_torch.core.table import days

from . import ast as A
from . import catalog as C
from .ir import output_columns
from .lexer import SqlError

__all__ = ["lower", "Rel"]

_AGG_FUNCS = ("sum", "count", "min", "max", "avg")

# Kind: (base, dict_name) where base is "int" | "float" | "dict"
_INT = ("int", None)
_FLOAT = ("float", None)
_BOOL = ("int", None)


def _pos(e) -> tuple:
    p = getattr(e, "pos", None)
    return p if p is not None else (None, None)


def _err(msg: str, e=None) -> SqlError:
    line, col = _pos(e) if e is not None else (None, None)
    return SqlError(msg, line, col)


@dataclasses.dataclass
class Rel:
    """A bound relation: plan node + name/type environment."""
    node: object
    cols: dict              # name -> (base, dict_name), insertion-ordered
    quals: dict             # alias -> frozenset of column names
    amb: set                # names dropped as ambiguous (join collisions)
    fds: dict               # col -> single join key that determines it
    uniq: set               # columns unique per row of this relation

    def child(self, node) -> "Rel":
        return dataclasses.replace(self, node=node)


class _Env:
    def __init__(self):
        self.ctes: dict[str, Rel] = {}
        self.params: dict[str, P.Param] = {}


# ------------------------------------------------------------- AST helpers

def _ast_conjuncts(e, hints=()) -> list:
    """Split on AND at the AST level, carrying predicate hints along.  A hint
    trailing an AND chain attaches to the chain's last conjunct."""
    if isinstance(e, A.Hinted):
        return _ast_conjuncts(e.a, tuple(hints) + tuple(e.hints))
    if isinstance(e, A.Binary) and e.op == "and":
        return _ast_conjuncts(e.a) + _ast_conjuncts(e.b, hints)
    return [(e, tuple(hints))]


def _a_children(e):
    if isinstance(e, A.Unary):
        return (e.a,)
    if isinstance(e, A.Binary):
        return (e.a, e.b)
    if isinstance(e, A.Between):
        return (e.a, e.lo, e.hi)
    if isinstance(e, (A.InList,)):
        return (e.a,) + tuple(e.items)
    if isinstance(e, (A.LikeE, A.Hinted)):
        return (e.a,)
    if isinstance(e, A.CaseE):
        out = []
        for c, v in e.whens:
            out += [c, v]
        if e.default is not None:
            out.append(e.default)
        return tuple(out)
    if isinstance(e, A.Func):
        return tuple(e.args)
    # InQuery / ExistsE / Scalar: do not descend into subqueries
    if isinstance(e, A.InQuery):
        return (e.a,)
    return ()


def _contains_agg(e) -> bool:
    if isinstance(e, A.Func) and e.name in _AGG_FUNCS:
        return True
    return any(_contains_agg(c) for c in _a_children(e))


def _find_aggs(e) -> list:
    """Top-most aggregate Func nodes inside ``e`` (no aggs nest in TPC-H)."""
    if isinstance(e, A.Func) and e.name in _AGG_FUNCS:
        for a in e.args:
            if _contains_agg(a):
                raise _err("nested aggregates are unsupported")
        return [e]
    out = []
    for c in _a_children(e):
        out += _find_aggs(c)
    return out


def _date_arith(d: A.DateL, iv: A.IntervalL, sign: int):
    try:
        dt = datetime.date.fromisoformat(d.value)
    except ValueError:
        raise _err(f"bad date literal {d.value!r}") from None
    if iv.unit == "day":
        dt = dt + datetime.timedelta(days=sign * iv.n)
    else:
        months = sign * iv.n * (12 if iv.unit == "year" else 1)
        m = dt.month - 1 + months
        y, m = dt.year + m // 12, m % 12 + 1
        try:
            dt = dt.replace(year=y, month=m)
        except ValueError:
            raise _err(f"date {d.value} {'+' if sign > 0 else '-'} interval "
                       f"'{iv.n}' {iv.unit}: day-of-month overflow") from None
    return P.Lit(days(dt.isoformat())), _INT


_FOLD = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
         "*": lambda a, b: a * b, "/": lambda a, b: a / b}


# --------------------------------------------------------------- the binder

class _Lower:
    def __init__(self):
        self.env = _Env()

    # ------------------------------------------------------- name resolution
    def resolve(self, ident: A.Ident, rel: Rel) -> str:
        name = ident.name
        if ident.qualifier is not None:
            names = rel.quals.get(ident.qualifier)
            if names is None:
                raise _err(f"unknown table alias {ident.qualifier!r}", ident)
            if name not in names:
                raise _err(f"column {name!r} is not in table "
                           f"{ident.qualifier!r}", ident)
        if name in rel.amb:
            raise _err(f"ambiguous column {name!r} (qualify or alias it "
                       f"before the join)", ident)
        if name not in rel.cols:
            raise _err(f"unknown column {name!r}", ident)
        return name

    # ---------------------------------------------------------- expressions
    def expr(self, e, rel: Rel, agg_sub: dict | None = None):
        """Lower an AST expression; returns ``(plan_expr, kind)``."""
        if isinstance(e, A.Hinted):            # hint already consumed upstream
            return self.expr(e.a, rel, agg_sub)
        if isinstance(e, A.Ident):
            name = self.resolve(e, rel)
            return P.Col(name), rel.cols[name]
        if isinstance(e, A.Number):
            return P.Lit(e.value), (_FLOAT if isinstance(e.value, float)
                                    else _INT)
        if isinstance(e, A.DateL):
            return P.Lit(days(e.value)), _INT
        if isinstance(e, A.IntervalL):
            raise _err("INTERVAL is only valid added to / subtracted from a "
                       "DATE literal", e)
        if isinstance(e, A.String):
            raise _err("string literal used outside a dictionary-column "
                       "comparison (=, <>, IN, LIKE)", e)
        if isinstance(e, A.ParamE):
            p = self.env.params.get(e.name)
            if p is None:
                raise _err(f"undeclared parameter :{e.name} (add a DECLARE)",
                           e)
            return p, (_FLOAT if p.dtype == "float64" else _INT)
        if isinstance(e, A.Star):
            raise _err("* is only valid inside COUNT(*)", e)
        if isinstance(e, A.Unary):
            if e.op == "not":
                x, _ = self.expr(e.a, rel, agg_sub)
                return P.NotE(x), _BOOL
            if isinstance(e.a, A.Number):
                v = -e.a.value
                return P.Lit(v), (_FLOAT if isinstance(v, float) else _INT)
            x, k = self.expr(e.a, rel, agg_sub)
            if k[0] == "dict":
                raise _err("arithmetic on a dictionary-encoded column", e.a)
            return P.BinOp("-", P.Lit(0), x), k
        if isinstance(e, A.Binary):
            return self.binary(e, rel, agg_sub)
        if isinstance(e, A.Between):
            lo = A.Binary(">=", e.a, e.lo)
            hi = A.Binary("<=", e.a, e.hi)
            x, _ = self.expr(A.Binary("and", lo, hi), rel, agg_sub)
            return (P.NotE(x) if e.negated else x), _BOOL
        if isinstance(e, A.InList):
            return self.in_list(e, rel, agg_sub)
        if isinstance(e, (A.InQuery, A.ExistsE)):
            raise _err("IN (SELECT ...) / EXISTS is only supported as a "
                       "top-level WHERE or HAVING conjunct", getattr(e, "a",
                                                                     None))
        if isinstance(e, A.LikeE):
            return self.like(e, rel)
        if isinstance(e, A.CaseE):
            if e.default is None:
                raise _err("CASE requires an ELSE branch (columns are "
                           "non-null)")
            out, kind = self.expr(e.default, rel, agg_sub)
            for cond, val in reversed(e.whens):
                cx, _ = self.expr(cond, rel, agg_sub)
                vx, vk = self.expr(val, rel, agg_sub)
                kind = vk if vk[0] == "float" or kind[0] == "float" else kind
                out = P.Where(cx, vx, out)
            return out, kind
        if isinstance(e, A.Func):
            return self.func(e, rel, agg_sub)
        if isinstance(e, A.Scalar):
            return self.scalar_subquery(e.query, rel)
        raise _err(f"cannot lower {type(e).__name__}")

    def binary(self, e: A.Binary, rel, agg_sub):
        op = e.op
        if op in ("or", "and"):
            a, _ = self.expr(e.a, rel, agg_sub)
            b, _ = self.expr(e.b, rel, agg_sub)
            return P.BinOp("|" if op == "or" else "&", a, b), _BOOL
        # date +/- interval folds host-side, calendar-aware
        if op in ("+", "-") and isinstance(e.a, A.DateL) \
                and isinstance(e.b, A.IntervalL):
            return _date_arith(e.a, e.b, 1 if op == "+" else -1)
        if op in ("=", "<>", "!=", "<", "<=", ">", ">="):
            pop = {"=": "==", "<>": "!=", "!=": "!="}.get(op, op)
            if isinstance(e.a, A.String) or isinstance(e.b, A.String):
                s = e.a if isinstance(e.a, A.String) else e.b
                o = e.b if isinstance(e.a, A.String) else e.a
                if op not in ("=", "<>"):
                    raise _err("dictionary columns support only = and <> "
                               "against string literals", o)
                ox, kind = self.expr(o, rel, agg_sub)
                if kind[0] != "dict":
                    raise _err("string literal compared to a non-dictionary "
                               "expression", o)
                return P.BinOp(pop, ox, P.CodeLit(kind[1], s.value)), _BOOL
            ax, ka = self.expr(e.a, rel, agg_sub)
            bx, kb = self.expr(e.b, rel, agg_sub)
            if (ka[0] == "dict") != (kb[0] == "dict") and \
                    not isinstance(bx, P.CodeLit) and \
                    not isinstance(ax, P.CodeLit):
                raise _err("comparison mixes a dictionary column with a "
                           "non-dictionary expression", e.a)
            return P.BinOp(pop, ax, bx), _BOOL
        if op in ("+", "-", "*", "/"):
            ax, ka = self.expr(e.a, rel, agg_sub)
            bx, kb = self.expr(e.b, rel, agg_sub)
            if ka[0] == "dict" or kb[0] == "dict":
                raise _err("arithmetic on a dictionary-encoded column", e.a)
            if isinstance(ax, P.Lit) and isinstance(bx, P.Lit):
                v = _FOLD[op](ax.value, bx.value)
                return P.Lit(v), (_FLOAT if isinstance(v, float) else _INT)
            kind = _FLOAT if (op == "/" or ka[0] == "float"
                              or kb[0] == "float") else _INT
            return P.BinOp(op, ax, bx), kind
        raise _err(f"unsupported operator {op!r}")

    def in_list(self, e: A.InList, rel, agg_sub):
        ax, kind = self.expr(e.a, rel, agg_sub)
        vals = []
        for item in e.items:
            if isinstance(item, A.String):
                if kind[0] != "dict":
                    raise _err("string IN-list against a non-dictionary "
                               "column", item)
                vals.append(P.CodeLit(kind[1], item.value))
            else:
                vx, _ = self.expr(item, rel, agg_sub)
                if not isinstance(vx, (P.Lit, P.CodeLit)):
                    raise _err("IN list items must be literals", item)
                vals.append(vx)
        out = P.InSet(ax, vals)
        return (P.NotE(out) if e.negated else out), _BOOL

    def like(self, e: A.LikeE, rel):
        if not isinstance(e.a, A.Ident):
            raise _err("LIKE requires a plain column on the left", e.a)
        name = self.resolve(e.a, rel)
        kind = rel.cols[name]
        if kind[0] != "dict":
            raise _err(f"LIKE on non-dictionary column {name!r}", e.a)
        pat = e.pattern
        if "%" not in pat:
            out = P.BinOp("==", P.Col(name), P.CodeLit(kind[1], pat))
        elif pat.startswith("%") and pat.endswith("%"):
            subs = tuple(s for s in pat.split("%") if s)
            if not subs:
                raise _err("LIKE pattern matches everything", e.a)
            out = P.Like(name, subs)
        elif pat.endswith("%") and "%" not in pat[:-1]:
            out = P.StartsWith(name, pat[:-1])
        elif pat.startswith("%") and "%" not in pat[1:]:
            out = P.EndsWith(name, pat[1:])
        else:
            raise _err(f"unsupported LIKE pattern {pat!r} (use %...%, "
                       f"prefix%, %suffix or an exact string)", e.a)
        return (P.NotE(out) if e.negated else out), _BOOL

    def func(self, e: A.Func, rel, agg_sub):
        if e.name in _AGG_FUNCS:
            if agg_sub is not None and e in agg_sub:
                return agg_sub[e]
            raise _err(f"aggregate {e.name}() outside GROUP BY / scalar "
                       f"select context")
        if e.name == "year":
            x, k = self.expr(e.args[0], rel, agg_sub)
            if k[0] != "int":
                raise _err("extract(year ...) needs a date expression")
            return P.Year(x), _INT
        if e.name == "code":
            if len(e.args) != 2 or not all(isinstance(a, A.String)
                                           for a in e.args):
                raise _err("code(dict, value) takes two string literals")
            dname, value = e.args[0].value, e.args[1].value
            owner = C.column_table(dname)
            if owner is None or \
                    C.CATALOG[owner].columns[dname].kind != "dict":
                raise _err(f"code(): unknown dictionary {dname!r}")
            return P.CodeLit(dname, value), _INT
        if e.name == "dbscale":
            if e.args:
                raise _err("dbscale() takes no arguments")
            return P.DbScale(), _FLOAT
        raise _err(f"unknown function {e.name!r}")

    # --------------------------------------------------- scalar subqueries
    def agg_kind(self, f: A.Func, rel: Rel):
        if f.name == "count":
            return _INT
        if f.name == "avg":
            return _FLOAT
        arg = f.args[0]
        _, kind = self.expr(arg, rel)
        return kind

    def scalar_subquery(self, sel: A.Select, outer_rel: Rel):
        if sel.group or sel.having or sel.order or sel.limit is not None:
            raise _err("scalar subquery must be a plain aggregate select")
        if len(sel.items) != 1:
            raise _err("scalar subquery must produce exactly one value")
        rel = self.from_clause(sel.frm)
        if sel.where is not None:
            rel = self.where_clause(rel, sel.where)
        item = sel.items[0].expr
        aggs = _find_aggs(item)
        if not aggs:
            raise _err("scalar subquery must aggregate (sum/min/max/avg/"
                       "count)")
        specs, sub = self._intern_scalar_aggs(aggs, rel)
        node = P.AggScalar(rel.node, tuple(specs))
        for f, (name, kind) in sub.items():
            sub[f] = (P.ScalarRef(node, name), kind)
        return self.expr(item, rel, agg_sub=sub)

    def _intern_scalar_aggs(self, aggs, rel):
        specs, sub = [], {}
        for i, f in enumerate(aggs):
            if f in sub:
                continue
            if f.distinct:
                raise _err("DISTINCT aggregates are unsupported in scalar "
                           "subqueries")
            name = f"__s{len(specs)}"
            if f.name == "count":
                specs.append((name, "count", None))
            else:
                vx, _ = self.expr(f.args[0], rel)
                specs.append((name, f.name, vx))
            sub[f] = (name, self.agg_kind(f, rel))
        return specs, sub

    # ------------------------------------------------------------- FROM
    def table_ref(self, ref) -> Rel:
        if isinstance(ref, A.Derived):
            sub = self.select_rel(ref.query)
            return Rel(sub.node, dict(sub.cols),
                       {ref.alias: frozenset(sub.cols)}, set(sub.amb),
                       dict(sub.fds), set(sub.uniq))
        name, alias = ref.name, ref.alias or ref.name
        base = self.env.ctes.get(name)
        if base is not None:
            return Rel(base.node, dict(base.cols),
                       {alias: frozenset(base.cols)}, set(base.amb),
                       dict(base.fds), set(base.uniq))
        td = C.CATALOG.get(name)
        if td is None:
            raise _err(f"unknown table {name!r}", ref)
        cols = {c: (cd.kind, cd.dict_name) for c, cd in td.columns.items()}
        return Rel(P.Scan(name), cols, {alias: frozenset(cols)}, set(), {},
                   set(td.unique))

    def _on_side(self, ident: A.Ident, left: Rel, right: Rel):
        if ident.qualifier is not None:
            if ident.qualifier in left.quals and \
                    ident.name in left.quals[ident.qualifier]:
                return "L", self.resolve(ident, left)
            if ident.qualifier in right.quals and \
                    ident.name in right.quals[ident.qualifier]:
                return "R", self.resolve(ident, right)
            raise _err(f"unknown qualified column "
                       f"{ident.qualifier}.{ident.name}", ident)
        in_l = ident.name in left.cols
        in_r = ident.name in right.cols
        if in_l and in_r:
            raise _err(f"ambiguous ON column {ident.name!r} (qualify it)",
                       ident)
        if in_l:
            return "L", self.resolve(ident, left)
        if in_r:
            return "R", self.resolve(ident, right)
        raise _err(f"unknown column {ident.name!r} in ON", ident)

    def join_step(self, left: Rel, step: A.JoinStep) -> Rel:
        right = self.table_ref(step.ref)
        pairs, residual = [], []
        for conj, hints in _ast_conjuncts(step.on):
            if hints:
                raise _err("hints are not valid inside ON")
            if isinstance(conj, A.Binary) and conj.op == "=" and \
                    isinstance(conj.a, A.Ident) and \
                    isinstance(conj.b, A.Ident):
                sa = self._on_side(conj.a, left, right)
                sb = self._on_side(conj.b, left, right)
                if {sa[0], sb[0]} == {"L", "R"}:
                    pc, bc = (sa[1], sb[1]) if sa[0] == "L" else \
                        (sb[1], sa[1])
                    pairs.append((pc, bc))
                    continue
            residual.append(conj)
        if not pairs:
            raise _err("JOIN ... ON needs at least one cross-side column "
                       "equality")
        on = pairs[0][0] if len(pairs) == 1 else tuple(p for p, _ in pairs)
        build_on = pairs[0][1] if len(pairs) == 1 else \
            tuple(b for _, b in pairs)
        bset = {b for _, b in pairs}

        take, amb = [], set(left.amb) | set(right.amb)
        for c in right.cols:
            if c in left.cols:
                if c in bset and any(pc == c for pc, bc in pairs if bc == c):
                    continue           # natural-key collision: probe side wins
                amb.add(c)
                continue
            take.append(c)

        cols = dict(left.cols)
        for c in take:
            cols[c] = right.cols[c]
        quals = dict(left.quals)
        quals.update(right.quals)

        build_unique = len(pairs) == 1 and pairs[0][1] in right.uniq
        fds = dict(left.fds)
        uniq = set(left.uniq) if build_unique else set()
        if build_unique:
            for c in take:
                fds[c] = pairs[0][0]

        if step.kind == "left":
            if residual:
                raise _err("LEFT JOIN supports only column equalities in ON")
            defaults = {c: (0.0 if right.cols[c][0] == "float" else 0)
                        for c in take}
            node = P.Left(left.node, right.node, on, build_on, tuple(take),
                          defaults)
        else:
            node = P.Join(left.node, right.node, on, build_on, tuple(take))
        rel = Rel(node, cols, quals, amb, fds, uniq)
        for conj in residual:
            pred, _ = self.expr(conj, rel)
            rel = rel.child(P.Filter(rel.node, pred))
        return rel

    def from_clause(self, frm) -> Rel:
        if len(frm) != 1:
            raise _err("comma joins are unsupported: use explicit "
                       "JOIN ... ON")
        rel = self.table_ref(frm[0].ref)
        for step in frm[0].joins:
            rel = self.join_step(rel, step)
        return rel

    # ------------------------------------------------------------- WHERE
    def where_clause(self, rel: Rel, where) -> Rel:
        for conj, hints in _ast_conjuncts(where):
            neg = False
            while isinstance(conj, A.Unary) and conj.op == "not" and \
                    isinstance(conj.a, (A.InQuery, A.ExistsE)):
                neg, conj = not neg, conj.a
            if isinstance(conj, A.InQuery):
                rel = self.semi_anti(rel, conj, conj.negated ^ neg)
            elif isinstance(conj, A.ExistsE):
                rel = self.exists(rel, conj, conj.negated ^ neg)
            else:
                pred, _ = self.expr(conj, rel)
                rel = rel.child(P.Filter(rel.node, pred))
            for hk, hn in hints:
                if hk != "shrink":
                    raise _err(f"hint {hk!r} is not valid on a predicate "
                               f"(only shrink(N))")
                rel = rel.child(P.Shrink(rel.node, hn))
        return rel

    def semi_anti(self, rel: Rel, e: A.InQuery, negated: bool) -> Rel:
        if not isinstance(e.a, A.Ident):
            raise _err("IN (SELECT ...) requires a plain column on the left",
                       e.a)
        pc = self.resolve(e.a, rel)
        sub = self.select_rel(e.query)
        if len(sub.cols) != 1:
            raise _err("IN subquery must produce exactly one column")
        bc = next(iter(sub.cols))
        cls = P.Anti if negated else P.Semi
        return rel.child(cls(rel.node, sub.node, pc, bc))

    def exists(self, rel: Rel, e: A.ExistsE, negated: bool) -> Rel:
        sel = e.query
        if sel.group or sel.having or sel.order or sel.limit is not None:
            raise _err("EXISTS subquery must be a plain filtered select")
        sub = self.from_clause(sel.frm)
        pairs, inner = [], []
        if sel.where is not None:
            for conj, hints in _ast_conjuncts(sel.where):
                if hints:
                    raise _err("hints are not valid inside EXISTS")
                if isinstance(conj, A.Binary) and conj.op == "=" and \
                        isinstance(conj.a, A.Ident) and \
                        isinstance(conj.b, A.Ident):
                    sides = []
                    for ident in (conj.a, conj.b):
                        if ident.name in sub.cols and (
                                ident.qualifier is None or
                                ident.qualifier in sub.quals):
                            sides.append(("I", self.resolve(ident, sub)))
                        elif ident.name in rel.cols:
                            sides.append(("O", self.resolve(ident, rel)))
                        else:
                            sides.append(("?", ident.name))
                    if {sides[0][0], sides[1][0]} == {"I", "O"}:
                        oc, ic = (sides[0][1], sides[1][1]) \
                            if sides[0][0] == "O" else \
                            (sides[1][1], sides[0][1])
                        pairs.append((oc, ic))
                        continue
                inner.append(conj)
        if not pairs:
            raise _err("EXISTS subquery must correlate on at least one "
                       "outer = inner column equality")
        for conj in inner:
            pred, _ = self.expr(conj, sub)
            sub = sub.child(P.Filter(sub.node, pred))
        on = pairs[0][0] if len(pairs) == 1 else tuple(p for p, _ in pairs)
        build_on = pairs[0][1] if len(pairs) == 1 else \
            tuple(b for _, b in pairs)
        cls = P.Anti if negated else P.Semi
        return rel.child(cls(rel.node, sub.node, on, build_on))

    # ---------------------------------------------------------- GROUP BY
    def group_clause(self, rel: Rel, sel: A.Select) -> Rel:
        alias_map = {it.alias: it.expr for it in sel.items if it.alias}
        pre, keys, key_kinds = {}, [], {}
        for g in sel.group:
            if not isinstance(g, A.Ident):
                raise _err("GROUP BY must list column names or select "
                           "aliases")
            if g.qualifier is None and g.name in alias_map and \
                    g.name not in rel.cols:
                src = alias_map[g.name]
                if isinstance(src, A.Ident):
                    keys.append(self.resolve(src, rel))
                else:
                    px, kind = self.expr(src, rel)
                    pre[g.name] = px
                    key_kinds[g.name] = kind
                    keys.append(g.name)
            else:
                keys.append(self.resolve(g, rel))
        if len(set(keys)) != len(keys):
            raise _err("duplicate GROUP BY key")

        node = rel.node
        if pre:
            node = P.WithCol(node, pre)
        work = dataclasses.replace(rel, node=node,
                                   cols={**rel.cols, **key_kinds})

        # collect aggregates from items + having, interned structurally
        agg_nodes: list[A.Func] = []
        for it in sel.items:
            agg_nodes += _find_aggs(it.expr)
        if sel.having is not None:
            agg_nodes += _find_aggs(sel.having)
        distinct = [f for f in agg_nodes if f.distinct]

        # functional-dependency key reduction (Q3): one key determines the
        # rest via unique-build joins -> group on it alone, recover the rest
        recovery = []
        if len(keys) > 1 and not distinct:
            for k in keys:
                others = [k2 for k2 in keys if k2 != k]
                if all(work.fds.get(k2) == k for k2 in others):
                    recovery = others
                    keys = [k]
                    break

        specs, sub = [], {}
        names_used = set(keys) | set(recovery)

        def fresh(base):
            if base not in names_used:
                return base
            i = 0
            while f"{base}_{i}" in names_used:
                i += 1
            return f"{base}_{i}"

        if distinct:
            if len(agg_nodes) != 1 or agg_nodes[0].name != "count":
                raise _err("COUNT(DISTINCT col) cannot mix with other "
                           "aggregates")
            f = agg_nodes[0]
            if not isinstance(f.args[0], A.Ident):
                raise _err("COUNT(DISTINCT ...) requires a plain column")
            dcol = self.resolve(f.args[0], work)
            inner = P.GroupBy(node, tuple(keys) + (dcol,),
                              (("__d", "count", None),), "local", False,
                              None)
            name = self._agg_name(sel, f, fresh)
            specs.append((name, "count", None))
            sub[f] = (P.Col(name), _INT)
            node = inner
        else:
            for f in agg_nodes:
                if f in sub:
                    continue
                name = self._agg_name(sel, f, fresh)
                names_used.add(name)
                if f.name == "count":
                    specs.append((name, "count", None))
                else:
                    vx, _ = self.expr(f.args[0], work)
                    specs.append((name, f.name, vx))
                sub[f] = (P.Col(name), self.agg_kind(f, work))
        for k2 in recovery:
            specs.append((k2, "max", k2))

        groups_hint = None
        for hk, hn in sel.hints:
            if hk == "groups":
                groups_hint = hn
        gb = P.GroupBy(node, tuple(keys), tuple(specs), "local", False,
                       groups_hint)

        cols = {}
        for k in keys:
            cols[k] = key_kinds.get(k) or work.cols[k]
        for name, op, v in gb.aggs:
            if name in recovery:
                cols[name] = work.cols[name]
            else:
                f = next(f for f, (cx, _) in sub.items()
                         if isinstance(cx, P.Col) and cx.name == name)
                cols[name] = sub[f][1]
        out = Rel(gb, cols, {}, set(), {},
                  set(keys) if len(keys) == 1 else set())

        if sel.having is not None:
            for conj, hints in _ast_conjuncts(sel.having):
                if isinstance(conj, (A.InQuery, A.ExistsE)):
                    raise _err("IN/EXISTS subqueries are not supported in "
                               "HAVING")
                pred, _ = self.expr(conj, out, agg_sub=sub)
                out = out.child(P.Filter(out.node, pred))
                for hk, hn in hints:
                    if hk != "shrink":
                        raise _err(f"hint {hk!r} is not valid on a HAVING "
                                   f"predicate")
                    out = out.child(P.Shrink(out.node, hn))
        return self.apply_items(out, sel.items, agg_sub=sub)

    @staticmethod
    def _agg_name(sel: A.Select, f: A.Func, fresh) -> str:
        for it in sel.items:
            if it.expr == f and it.alias:
                return fresh(it.alias)
        return fresh("__a0")

    # --------------------------------------------------------- select items
    def apply_items(self, rel: Rel, items, agg_sub=None) -> Rel:
        renames, withcols, kinds, names_out = {}, {}, {}, []
        for it in items:
            e = it.expr
            if isinstance(e, A.Ident):
                nm = self.resolve(e, rel)
                out = it.alias or nm
                if out != nm:
                    if nm in renames and renames[nm] != out:
                        raise _err(f"column {nm!r} selected under two "
                                   f"aliases", e)
                    renames[nm] = out
                kinds[out] = rel.cols[nm]
            elif agg_sub is not None and isinstance(e, A.Func) \
                    and e in agg_sub:
                cx, kind = agg_sub[e]
                nm = cx.name
                out = it.alias or nm
                if out != nm:
                    renames[nm] = out
                kinds[out] = kind
            elif agg_sub is not None and it.alias and it.alias in rel.cols:
                # computed GROUP BY key (e.g. year(...) as y): group_clause
                # already materialized it pre-aggregation under this alias
                out = it.alias
                kinds[out] = rel.cols[out]
            else:
                if not it.alias:
                    raise _err("computed select item needs AS <alias>")
                px, kind = self.expr(e, rel, agg_sub)
                out = it.alias
                withcols[out] = px
                kinds[out] = kind
            if out in names_out:
                raise _err(f"duplicate output column {out!r}")
            names_out.append(out)

        node = rel.node
        if withcols:
            node = P.WithCol(node, withcols)
        if renames:
            clash = set(renames.values()) & (set(rel.cols) |
                                             set(withcols)) - set(renames)
            if clash:
                raise _err(f"alias collides with an existing column: "
                           f"{sorted(clash)}")
            node = P.Rename(node, renames)
        if output_columns(node) != names_out:
            node = P.Select(node, names_out)
        return Rel(node, {n: kinds[n] for n in names_out}, {}, set(), {},
                   rel.uniq & set(names_out))

    # ----------------------------------------------------------- selects
    def select_rel(self, sel: A.Select, top: bool = False):
        rel = self.from_clause(sel.frm)
        if sel.where is not None:
            rel = self.where_clause(rel, sel.where)
        has_agg = any(_contains_agg(it.expr) for it in sel.items) or (
            sel.having is not None)
        if sel.group:
            rel = self.group_clause(rel, sel)
        elif has_agg:
            if not top:
                raise _err("an aggregate select without GROUP BY is only "
                           "valid as the outermost query or a scalar "
                           "subquery")
            return self.scalar_top(rel, sel)
        else:
            if sel.having is not None:
                raise _err("HAVING requires GROUP BY")
            rel = self.apply_items(rel, sel.items)
        for hk, hn in sel.hints:
            if hk == "shrink":
                rel = rel.child(P.Shrink(rel.node, hn))
            elif hk == "groups" and not sel.group:
                raise _err("groups(N) hint requires GROUP BY")
        if not top and (sel.order or sel.limit is not None):
            raise _err("ORDER BY / LIMIT are only supported in the "
                       "outermost SELECT")
        if not top:
            return rel
        return self.finalize(rel, sel)

    def scalar_top(self, rel: Rel, sel: A.Select):
        if sel.order or sel.limit is not None or sel.having is not None:
            raise _err("a scalar aggregate select takes no HAVING/ORDER/"
                       "LIMIT")
        agg_nodes = []
        for it in sel.items:
            if not it.alias:
                raise _err("scalar select items need AS <alias>")
            agg_nodes += _find_aggs(it.expr)
        specs, sub = self._intern_scalar_aggs(agg_nodes, rel)
        node = P.AggScalar(rel.node, tuple(specs))
        for f, (name, kind) in list(sub.items()):
            sub[f] = (P.ScalarRef(node, name), kind)
        exprs = {}
        for it in sel.items:
            px, _ = self.expr(it.expr, rel, agg_sub=sub)
            exprs[it.alias] = px
        return P.ScalarResult(exprs)

    def finalize(self, rel: Rel, sel: A.Select):
        node = rel.node
        sort_keys = []
        ranks = {}
        out_names = list(rel.cols)
        for oe, asc in sel.order:
            if not isinstance(oe, A.Ident) or oe.qualifier is not None:
                raise _err("ORDER BY must reference a select column or "
                           "alias")
            if oe.name not in rel.cols:
                raise _err(f"ORDER BY column {oe.name!r} is not in the "
                           f"select list", oe)
            kind = rel.cols[oe.name]
            # alpha-rank any column ordered under a dictionary's own name
            # whose codes are not already alphabetical: true dict columns,
            # and int columns carrying dict codes (e.g. ``s_nationkey as
            # n_name`` — no nation join, no extra sort).  A dict column
            # renamed AWAY from its dictionary is an error; a code-carrying
            # int under its own name just sorts by raw code.
            if kind[1] is not None and kind[1] not in C.ALPHA_CODED \
                    and oe.name == kind[1]:
                rk = f"__rank_{oe.name}"
                ranks[rk] = P.AlphaRank(oe.name)
                sort_keys.append((rk, asc))
            elif kind[0] == "dict" and kind[1] not in C.ALPHA_CODED:
                raise _err(f"cannot ORDER BY renamed dictionary column "
                           f"{oe.name!r} (alpha rank needs the "
                           f"dictionary name)", oe)
            else:
                sort_keys.append((oe.name, asc))
        if ranks:
            node = P.WithCol(node, ranks)
            out_names += list(ranks)
            node = P.Select(node, out_names)
        return P.Finalize(node, tuple(sort_keys) if sort_keys else None,
                          sel.limit, False)

    # ------------------------------------------------------------ queries
    def const(self, e) -> object:
        empty = Rel(None, {}, {}, set(), {}, set())
        x, _ = self.expr(e, empty)
        if not isinstance(x, P.Lit):
            raise _err("DECLARE bounds must be literal expressions")
        return x.value

    def query(self, q: A.Query):
        for d in q.declares:
            if d.name in self.env.params:
                raise _err(f"duplicate DECLARE {d.name}")
            lo, hi, dv = self.const(d.lo), self.const(d.hi), \
                self.const(d.default)
            dtype = "float64" if d.dtype == "float" else "int64"
            try:
                self.env.params[d.name] = P.Param(d.name, lo=lo, hi=hi,
                                                  default=dv, dtype=dtype)
            except ValueError as ex:
                raise _err(f"bad DECLARE {d.name}: {ex}") from None
        for name, sel in q.ctes:
            if name in self.env.ctes or name in C.CATALOG:
                raise _err(f"CTE {name!r} shadows an existing table")
            self.env.ctes[name] = self.select_rel(sel)
        return self.select_rel(q.body, top=True)


def lower(q: A.Query):
    """Lower a parsed query to a naive plan root (Finalize/ScalarResult)."""
    return _Lower().query(q)
