"""Typed AST for the SQL subset, plus a canonical printer.

Every node is a frozen dataclass with structural equality, so the hypothesis
round-trip property ``parse_expr(format_expr(e)) == e`` is a plain ``==``.
Collections are tuples (hashable, immutable).  The printer emits canonical
SQL the parser accepts — it is the other half of that round trip and the
basis of ``PlanTemplate.from_sql`` debugging output.
"""
from __future__ import annotations

import dataclasses as dc

__all__ = [
    "Expr", "Ident", "Number", "String", "DateL", "IntervalL", "ParamE",
    "Star", "Unary", "Binary", "Between", "InList", "InQuery", "ExistsE",
    "LikeE", "CaseE", "Func", "Scalar", "Hinted",
    "SelectItem", "Table", "Derived", "JoinStep", "FromItem",
    "Select", "Declare", "Query", "format_expr", "format_query",
]


class Expr:
    pass


@dc.dataclass(frozen=True)
class Ident(Expr):
    name: str
    qualifier: str | None = None
    # source position for binder errors; excluded from structural equality so
    # the parse/print round trip compares clean
    pos: tuple[int, int] | None = dc.field(default=None, compare=False,
                                           repr=False)


@dc.dataclass(frozen=True)
class Number(Expr):
    value: int | float


@dc.dataclass(frozen=True)
class String(Expr):
    value: str


@dc.dataclass(frozen=True)
class DateL(Expr):
    value: str                  # "YYYY-MM-DD"


@dc.dataclass(frozen=True)
class IntervalL(Expr):
    n: int
    unit: str                   # "day" | "month" | "year"


@dc.dataclass(frozen=True)
class ParamE(Expr):
    name: str


@dc.dataclass(frozen=True)
class Star(Expr):
    pass


@dc.dataclass(frozen=True)
class Unary(Expr):
    op: str                     # "-" | "not"
    a: Expr


@dc.dataclass(frozen=True)
class Binary(Expr):
    op: str                     # or and = <> < <= > >= + - * /
    a: Expr
    b: Expr


@dc.dataclass(frozen=True)
class Between(Expr):
    a: Expr
    lo: Expr
    hi: Expr
    negated: bool = False


@dc.dataclass(frozen=True)
class InList(Expr):
    a: Expr
    items: tuple[Expr, ...]
    negated: bool = False


@dc.dataclass(frozen=True)
class InQuery(Expr):
    a: Expr
    query: "Select"
    negated: bool = False


@dc.dataclass(frozen=True)
class ExistsE(Expr):
    query: "Select"
    negated: bool = False


@dc.dataclass(frozen=True)
class LikeE(Expr):
    a: Expr
    pattern: str
    negated: bool = False


@dc.dataclass(frozen=True)
class CaseE(Expr):
    whens: tuple[tuple[Expr, Expr], ...]
    default: Expr | None


@dc.dataclass(frozen=True)
class Func(Expr):
    name: str                   # lower-case: sum count min max avg year ...
    args: tuple[Expr, ...]
    distinct: bool = False


@dc.dataclass(frozen=True)
class Scalar(Expr):
    """A scalar subquery used as an expression."""
    query: "Select"


@dc.dataclass(frozen=True)
class Hinted(Expr):
    """A predicate carrying an optimizer hint (``expr /*+ shrink(N) */``).

    The hint asserts a data property the optimizer cannot prove (e.g. "at
    most N rows survive this predicate"); lowering turns it into a
    ``Shrink`` cap, and the runtime range checks still verify the claim.
    """
    a: Expr
    hints: tuple[tuple[str, int], ...]


# ---------------------------------------------------------------- queries

@dc.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: str | None = None


@dc.dataclass(frozen=True)
class Table:
    name: str
    alias: str | None = None
    pos: tuple[int, int] | None = dc.field(default=None, compare=False,
                                           repr=False)


@dc.dataclass(frozen=True)
class Derived:
    query: "Select"
    alias: str = ""


@dc.dataclass(frozen=True)
class JoinStep:
    kind: str                   # "inner" | "left"
    ref: "Table | Derived"
    on: Expr


@dc.dataclass(frozen=True)
class FromItem:
    ref: "Table | Derived"
    joins: tuple[JoinStep, ...] = ()


@dc.dataclass(frozen=True)
class Select:
    items: tuple[SelectItem, ...]
    frm: tuple[FromItem, ...]
    where: Expr | None = None
    group: tuple[Expr, ...] = ()
    having: Expr | None = None
    order: tuple[tuple[Expr, bool], ...] = ()       # (expr, ascending)
    limit: int | None = None
    hints: tuple[tuple[str, int], ...] = ()         # e.g. (("groups", 256),)


@dc.dataclass(frozen=True)
class Declare:
    name: str
    dtype: str                  # "int" | "float" | "date"
    lo: Expr
    hi: Expr
    default: Expr


@dc.dataclass(frozen=True)
class Query:
    body: Select
    ctes: tuple[tuple[str, Select], ...] = ()
    declares: tuple[Declare, ...] = ()


# ---------------------------------------------------------------- printer

# binding strength for parenthesization (higher binds tighter)
_PREC = {"or": 1, "and": 2, "=": 4, "<>": 4, "<": 4, "<=": 4, ">": 4,
         ">=": 4, "+": 5, "-": 5, "*": 6, "/": 6}
_NOT_PREC = 3


def _p(e: Expr, parent_prec: int) -> str:
    s, prec = _fmt(e)
    return f"({s})" if prec < parent_prec else s


def _fmt(e: Expr) -> tuple[str, int]:
    """Render ``e``; return (text, binding strength of its top operator)."""
    atom = 9
    if isinstance(e, Ident):
        text = f"{e.qualifier}.{e.name}" if e.qualifier else e.name
        return text, atom
    if isinstance(e, Number):
        return repr(e.value), atom
    if isinstance(e, String):
        return "'" + e.value.replace("'", "''") + "'", atom
    if isinstance(e, DateL):
        return f"date '{e.value}'", atom
    if isinstance(e, IntervalL):
        return f"interval '{e.n}' {e.unit}", atom
    if isinstance(e, ParamE):
        return f":{e.name}", atom
    if isinstance(e, Star):
        return "*", atom
    if isinstance(e, Unary):
        if e.op == "not":
            return f"not {_p(e.a, _NOT_PREC + 1)}", _NOT_PREC
        return f"-{_p(e.a, 7)}", 7
    if isinstance(e, Binary):
        prec = _PREC[e.op]
        # left-assoc: right operand of same precedence needs parens
        return (f"{_p(e.a, prec)} {e.op} {_p(e.b, prec + 1)}", prec)
    if isinstance(e, Between):
        neg = "not " if e.negated else ""
        return (f"{_p(e.a, 5)} {neg}between {_p(e.lo, 5)} and {_p(e.hi, 5)}",
                4)
    if isinstance(e, InList):
        neg = "not " if e.negated else ""
        items = ", ".join(_fmt(x)[0] for x in e.items)
        return f"{_p(e.a, 5)} {neg}in ({items})", 4
    if isinstance(e, InQuery):
        neg = "not " if e.negated else ""
        return f"{_p(e.a, 5)} {neg}in ({format_select(e.query)})", 4
    if isinstance(e, ExistsE):
        neg = "not " if e.negated else ""
        return f"{neg}exists ({format_select(e.query)})", 4
    if isinstance(e, LikeE):
        neg = "not " if e.negated else ""
        pat = e.pattern.replace("'", "''")
        return f"{_p(e.a, 5)} {neg}like '{pat}'", 4
    if isinstance(e, CaseE):
        parts = ["case"]
        for cond, val in e.whens:
            parts.append(f"when {_fmt(cond)[0]} then {_fmt(val)[0]}")
        if e.default is not None:
            parts.append(f"else {_fmt(e.default)[0]}")
        parts.append("end")
        return " ".join(parts), atom
    if isinstance(e, Func):
        if e.name == "count" and e.args == (Star(),):
            return "count(*)", atom
        d = "distinct " if e.distinct else ""
        args = ", ".join(_fmt(a)[0] for a in e.args)
        return f"{e.name}({d}{args})", atom
    if isinstance(e, Scalar):
        return f"({format_select(e.query)})", atom
    if isinstance(e, Hinted):
        s, prec = _fmt(e.a)
        hints = " ".join(f"/*+ {k}({n}) */" for k, n in e.hints)
        return f"{s} {hints}", prec
    raise TypeError(f"cannot format {type(e).__name__}")


def format_expr(e: Expr) -> str:
    return _fmt(e)[0]


def format_select(s: Select) -> str:
    parts = ["select"]
    for kind, n in s.hints:
        parts.append(f"/*+ {kind}({n}) */")
    cols = []
    for it in s.items:
        cols.append(format_expr(it.expr)
                    + (f" as {it.alias}" if it.alias else ""))
    parts.append(", ".join(cols))
    frm = []
    for item in s.frm:
        text = _fmt_ref(item.ref)
        for j in item.joins:
            kw = "left join" if j.kind == "left" else "join"
            text += f" {kw} {_fmt_ref(j.ref)} on {format_expr(j.on)}"
        frm.append(text)
    parts.append("from " + ", ".join(frm))
    if s.where is not None:
        parts.append("where " + format_expr(s.where))
    if s.group:
        parts.append("group by " + ", ".join(format_expr(g) for g in s.group))
    if s.having is not None:
        parts.append("having " + format_expr(s.having))
    if s.order:
        parts.append("order by " + ", ".join(
            format_expr(e) + ("" if asc else " desc") for e, asc in s.order))
    if s.limit is not None:
        parts.append(f"limit {s.limit}")
    return " ".join(parts)


def _fmt_ref(ref: "Table | Derived") -> str:
    if isinstance(ref, Table):
        return ref.name + (f" as {ref.alias}" if ref.alias else "")
    return f"({format_select(ref.query)}) as {ref.alias}"


def format_query(q: Query) -> str:
    lines = []
    for d in q.declares:
        lines.append(f"declare {d.name} {d.dtype} default "
                     f"{format_expr(d.default)} in "
                     f"({format_expr(d.lo)}, {format_expr(d.hi)});")
    if q.ctes:
        ctes = ",\n".join(f"{name} as ({format_select(sel)})"
                          for name, sel in q.ctes)
        lines.append(f"with {ctes}")
    lines.append(format_select(q.body))
    return "\n".join(lines)
