"""Lazy logical query plans: a DataFrame-style builder over the Context API.

A query is built ONCE as a plain data structure — a DAG of logical operator
nodes carrying column-expression trees — and compiled by
:mod:`repro_torch.core.planner` into calls against the physical ``Context`` API
(``RefContext`` / ``LocalContext`` / ``DistContext``).  This is the layer the
paper's "manually-optimized tensor programs" (§4.4) were missing: with the
plan as data, the static hints the physical engine wants (``key_bits``,
``groups_hint``, sortless-vs-sorted aggregation) become *planner inferences*
instead of per-query editing conventions (see planner.py for the contract).

Two sub-languages:

  * **Expressions** (:class:`Expr`): column references (``col("l_qty")``),
    literals, arithmetic/comparison/boolean operators, and the TQP-style
    dictionary primitives (``scode`` / ``like`` / ``starts_with`` /
    ``ends_with`` / ``isin`` / ``alpha_rank`` / ``year``).  ``AggScalar[name]``
    yields a :class:`ScalarRef` so scalar sub-query results (Q11's total,
    Q15's max, Q22's average) compose into later expressions.
  * **Plan nodes** (:class:`LogicalTable` subclasses): ``Scan`` / ``Filter`` /
    ``Select`` / ``WithCol`` / ``Rename`` / ``Join`` / ``Semi`` / ``Anti`` /
    ``Left`` / ``GroupBy`` / ``AggScalar`` / ``Shuffle`` / ``Broadcast`` /
    ``Shrink`` / ``Finalize`` / ``ScalarResult``.  Exchange placement stays
    explicit plan structure (the paper's placement is authoritative); the
    planner *validates* it against a derived placement and derives paper
    Table-4 counts from the IR alone.

Node identity is object identity: reusing a builder value twice (Q15's
grouped partials feed both the max sub-query and the filter) makes a DAG, and
the compiler executes each node once — which is also what makes the per-plan
build-side join cache hit.

``GroupBy`` deliberately has NO ``key_bits`` parameter: provable key widths
are planner inferences.  ``groups_hint=`` remains available for bounds the
planner cannot prove (data-dependent group counts, e.g. Q13's orders-per-
customer histogram); everything provable is inferred and the hand hint
deleted.

The same principle extends to the wire: ``Shuffle`` / ``Broadcast`` /
exchanged ``GroupBy`` / ``Finalize`` nodes carry NO wire-format fields.  The
planner derives per-column ``(lo, hi)`` payload bounds from the identical
statistics pipeline (``PlanInfo.wire``) and the exchange layer ships each
column at its inferred lane width (``core/wire.py``), range-checked at pack
time — authors describe WHAT moves, the compiler decides HOW WIDE.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

__all__ = [
    # expressions
    "Expr", "Col", "Lit", "BinOp", "NotE", "Cast", "Where", "Year",
    "AlphaRank", "Like", "StartsWith", "EndsWith", "InSet", "CodeLit",
    "DbScale", "ScalarRef", "Param",
    # nodes
    "Node", "LogicalTable", "Scan", "Filter", "Select", "WithCol", "Rename",
    "Join", "Semi", "Anti", "Left", "GroupBy", "AggScalar", "Shuffle",
    "Broadcast", "Shrink", "Finalize", "ScalarResult",
    # builder helpers
    "scan", "col", "lit", "scode", "isin", "like", "starts_with",
    "ends_with", "alpha_rank", "year", "where", "db_scale", "result",
    "param",
    # reserved sample-ladder bookkeeping columns (repro_torch.approx)
    "SAMPLE_WEIGHT_COL", "SAMPLE_M_COL", "SAMPLE_N_COL",
]

# Reserved column names carried by stratified sample tables
# (repro_torch.approx.sampling): the Horvitz-Thompson scale-up weight n_g/m_g,
# the pre-filter per-stratum sample size m_g, and the true stratum size n_g.
# Plan authors must not define columns with these names.
SAMPLE_WEIGHT_COL = "__sw"
SAMPLE_M_COL = "__sm"
SAMPLE_N_COL = "__sn"


# ---------------------------------------------------------------------------
# expression language
# ---------------------------------------------------------------------------

def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


class Expr:
    """Column-expression tree node.  Operators build bigger trees; nothing is
    evaluated until the planner compiles the enclosing plan against a backend.

    ``__eq__``/``__ne__`` build comparison nodes (DataFrame idiom), so
    expressions must never be used as dict keys — plan DAGs key on ``id()``.
    """

    def __add__(self, o): return BinOp("+", self, _wrap(o))
    def __radd__(self, o): return BinOp("+", _wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, _wrap(o))
    def __rsub__(self, o): return BinOp("-", _wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, _wrap(o))
    def __rmul__(self, o): return BinOp("*", _wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, _wrap(o))
    def __rtruediv__(self, o): return BinOp("/", _wrap(o), self)
    def __lt__(self, o): return BinOp("<", self, _wrap(o))
    def __le__(self, o): return BinOp("<=", self, _wrap(o))
    def __gt__(self, o): return BinOp(">", self, _wrap(o))
    def __ge__(self, o): return BinOp(">=", self, _wrap(o))
    def __eq__(self, o): return BinOp("==", self, _wrap(o))   # type: ignore
    def __ne__(self, o): return BinOp("!=", self, _wrap(o))   # type: ignore
    def __and__(self, o): return BinOp("&", self, _wrap(o))
    def __rand__(self, o): return BinOp("&", _wrap(o), self)
    def __or__(self, o): return BinOp("|", self, _wrap(o))
    def __ror__(self, o): return BinOp("|", _wrap(o), self)
    def __invert__(self): return NotE(self)
    __hash__ = object.__hash__

    def __bool__(self):
        # `a <= x < b` / `p and q` / `x in [...]` would silently truthify an
        # expression node and drop a conjunct; force the explicit operators
        raise TypeError(
            "an Expr has no truth value: use & | ~ instead of and/or/not, "
            "and split chained comparisons into explicit conjuncts")

    def astype(self, dtype: str) -> "Expr":
        return Cast(self, dtype)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name


class Lit(Expr):
    def __init__(self, value):
        self.value = value


class BinOp(Expr):
    def __init__(self, op: str, a: Expr, b: Expr):
        self.op, self.a, self.b = op, a, b


class NotE(Expr):
    def __init__(self, a: Expr):
        self.a = a


class Cast(Expr):
    def __init__(self, a: Expr, dtype: str):
        self.a, self.dtype = a, dtype


class Where(Expr):
    def __init__(self, cond: Expr, a: Expr, b: Expr):
        self.cond, self.a, self.b = cond, _wrap(a), _wrap(b)


class Year(Expr):
    """Calendar year of an epoch-days expression (host LUT at execution)."""
    def __init__(self, a: Expr):
        self.a = a


class AlphaRank(Expr):
    """Alphabetical rank of a dictionary-encoded column (ORDER BY strings)."""
    def __init__(self, col: str):
        self.col = col


class Like(Expr):
    """Ordered-substring LIKE over the dictionary of ``col``."""
    def __init__(self, col: str, subs: tuple):
        self.col, self.subs = col, subs


class StartsWith(Expr):
    def __init__(self, col: str, prefix: str):
        self.col, self.prefix = col, prefix


class EndsWith(Expr):
    def __init__(self, col: str, suffix: str):
        self.col, self.suffix = col, suffix


class InSet(Expr):
    """Membership in a small literal set (ints or dictionary codes)."""
    def __init__(self, a: Expr, values: Sequence):
        values = tuple(_wrap(v) for v in values)
        if not values:
            # fail at the authoring site, not as an IndexError mid-trace
            raise ValueError("isin: empty value set")
        self.a = a
        self.values = values


class CodeLit(Expr):
    """Dictionary code of an exact string value, resolved host-side at
    compile/execution time (``db.code``)."""
    def __init__(self, col: str, value: str):
        self.col, self.value = col, value


class DbScale(Expr):
    """The database scale factor (host metadata) as a scalar literal."""


class ScalarRef(Expr):
    """One named scalar out of an :class:`AggScalar` node's result."""
    def __init__(self, node: "AggScalar", name: str):
        self.node, self.name = node, name


class Param(Expr):
    """Named runtime parameter of a plan *template*.

    A plan containing ``Param`` nodes is a TEMPLATE: one logical DAG (and one
    preparation, through ``repro_torch.serve``) serves every parameter
    binding.  The placeholder carries its DOMAIN, not a value:

      * ``lo`` / ``hi`` declare the closed interval every future binding must
        fall in.  The planner folds the **domain** — never any single binding
        — into filter refinement, ``key_bits`` and wire bounds, so a cached
        ``PlanInfo`` (and any compiled program derived from it) is sound for
        every admissible binding.  Bindings outside the domain are rejected
        host-side at bind time (``serve.PlanTemplate.bind``); anything that
        slips past stale statistics still trips the engine's runtime range
        checks into ``ctx.overflow`` — never a silent wrong answer.
      * ``default`` serves when a binding omits the parameter.
      * ``dtype`` ("int64" / "float64") pins the traced scalar's dtype so
        re-binding never re-traces a compiled template; inferred from
        ``lo``/``hi``/``default`` when omitted (float anywhere -> float64).

    Domainless parameters are allowed and simply contribute no provable
    bounds (filters over them refine nothing — the conservative, always-sound
    degradation).
    """

    def __init__(self, name: str, lo=None, hi=None, default=None,
                 dtype: str | None = None):
        if not isinstance(name, str) or not name:
            raise ValueError("param: name must be a non-empty string")
        if (lo is None) != (hi is None):
            raise ValueError(f"param {name!r}: declare both lo and hi, "
                             f"or neither")
        if lo is not None and lo > hi:
            raise ValueError(f"param {name!r}: empty domain [{lo}, {hi}]")
        self.name, self.lo, self.hi, self.default = name, lo, hi, default
        if dtype is None:
            probe = [v for v in (lo, hi, default) if v is not None]
            dtype = "float64" if any(isinstance(v, float) for v in probe) \
                else "int64"
        if dtype not in ("int64", "float64"):
            raise ValueError(f"param {name!r}: unsupported dtype {dtype!r}")
        self.dtype = dtype

    def spec(self) -> tuple:
        """Identity tuple: two placeholders with one name must agree on it."""
        return (self.name, self.lo, self.hi, self.default, self.dtype)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------

_AGG_OPS = ("sum", "count", "min", "max", "avg")


def _check_aggs(aggs):
    aggs = tuple((n, op, (v if (v is None or isinstance(v, (str, Expr)))
                          else _wrap(v))) for n, op, v in aggs)
    for _, op, _v in aggs:
        if op not in _AGG_OPS:
            raise ValueError(f"unknown aggregate op {op!r}")
    return aggs


class Node:
    """Base plan node.  ``children`` lists input nodes (tables the operator
    consumes); expression-embedded scalar sub-queries are discovered by the
    planner's expression walk, not listed here."""
    children: tuple = ()
    __hash__ = object.__hash__


class LogicalTable(Node):
    """A node producing a (logical) table; carries the fluent builder API."""

    def filter(self, pred: Expr) -> "Filter":
        return Filter(self, pred)

    def select(self, *names: str) -> "Select":
        return Select(self, names)

    def with_col(self, **exprs: Expr) -> "WithCol":
        return WithCol(self, {k: _wrap(v) for k, v in exprs.items()})

    def rename(self, mapping: Mapping[str, str]) -> "Rename":
        return Rename(self, dict(mapping))

    def join(self, build: "LogicalTable", on, build_on,
             take: Sequence[str]) -> "Join":
        return Join(self, build, on, build_on, tuple(take))

    def semi(self, build: "LogicalTable", on, build_on) -> "Semi":
        return Semi(self, build, on, build_on)

    def anti(self, build: "LogicalTable", on, build_on) -> "Anti":
        return Anti(self, build, on, build_on)

    def left(self, build: "LogicalTable", on, build_on, take: Sequence[str],
             defaults: Mapping[str, Any]) -> "Left":
        return Left(self, build, on, build_on, tuple(take), dict(defaults))

    def group_by(self, keys: Sequence[str], aggs, exchange: str = "local",
                 final: bool = False, groups_hint: int | None = None,
                 ) -> "GroupBy":
        return GroupBy(self, tuple(keys), _check_aggs(aggs), exchange, final,
                       groups_hint)

    def agg_scalar(self, aggs) -> "AggScalar":
        return AggScalar(self, _check_aggs(aggs))

    def shuffle(self, key: str) -> "Shuffle":
        return Shuffle(self, key)

    def broadcast(self, p2p: bool = False) -> "Broadcast":
        return Broadcast(self, p2p)

    def shrink(self, cap: int) -> "Shrink":
        return Shrink(self, cap)

    def finalize(self, sort_keys=None, limit: int | None = None,
                 replicated: bool = False) -> "Finalize":
        return Finalize(self, tuple(sort_keys) if sort_keys else None, limit,
                        replicated)


class Scan(LogicalTable):
    def __init__(self, table: str):
        self.table = table


class Filter(LogicalTable):
    def __init__(self, child, pred: Expr):
        self.children = (child,)
        self.pred = pred


class Select(LogicalTable):
    def __init__(self, child, names: Sequence[str]):
        self.children = (child,)
        self.names = tuple(names)


class WithCol(LogicalTable):
    def __init__(self, child, exprs: dict):
        self.children = (child,)
        self.exprs = exprs


class Rename(LogicalTable):
    def __init__(self, child, mapping: dict):
        self.children = (child,)
        self.mapping = mapping


class _JoinBase(LogicalTable):
    def __init__(self, probe, build, on, build_on):
        self.children = (probe, build)
        self.on = on
        self.build_on = build_on

    @property
    def probe(self):
        return self.children[0]

    @property
    def build(self):
        return self.children[1]

    def on_pairs(self) -> list[tuple[str, str]]:
        """(probe_col, build_col) pairs when both sides name plain columns."""
        p = (self.on,) if isinstance(self.on, str) else tuple(self.on)
        b = (self.build_on,) if isinstance(self.build_on, str) \
            else tuple(self.build_on)
        return list(zip(p, b))


class Join(_JoinBase):
    def __init__(self, probe, build, on, build_on, take):
        super().__init__(probe, build, on, build_on)
        self.take = take


class Semi(_JoinBase):
    pass


class Anti(_JoinBase):
    pass


class Left(_JoinBase):
    def __init__(self, probe, build, on, build_on, take, defaults):
        super().__init__(probe, build, on, build_on)
        self.take = take
        self.defaults = defaults


class GroupBy(LogicalTable):
    def __init__(self, child, keys, aggs, exchange, final, groups_hint):
        if exchange not in ("local", "shuffle", "gather"):
            raise ValueError(f"unknown group_by exchange {exchange!r}")
        self.children = (child,)
        self.keys = keys
        self.aggs = aggs
        self.exchange = exchange
        self.final = final
        self.groups_hint = groups_hint   # plan-author claim; planner may tighten


class AggScalar(Node):
    """Scalar aggregation (allreduce).  Index with ``[name]`` to reference one
    result inside later expressions."""

    def __init__(self, child, aggs):
        self.children = (child,)
        self.aggs = aggs

    def __getitem__(self, name: str) -> ScalarRef:
        if name not in [n for n, _, _ in self.aggs]:
            raise KeyError(name)
        return ScalarRef(self, name)


class Shuffle(LogicalTable):
    def __init__(self, child, key: str):
        self.children = (child,)
        self.key = key


class Broadcast(LogicalTable):
    def __init__(self, child, p2p: bool):
        self.children = (child,)
        self.p2p = p2p


class Shrink(LogicalTable):
    def __init__(self, child, cap: int):
        self.children = (child,)
        self.cap = cap


class Finalize(Node):
    """Terminal result collection (gather + global ORDER BY / LIMIT)."""

    def __init__(self, child, sort_keys, limit, replicated):
        self.children = (child,)
        self.sort_keys = sort_keys
        self.limit = limit
        self.replicated = replicated


class ScalarResult(Node):
    """Terminal dict of named scalar expressions (Q6/Q14/Q17/Q19-style)."""

    def __init__(self, exprs: dict):
        self.exprs = {k: _wrap(v) for k, v in exprs.items()}


# ---------------------------------------------------------------------------
# builder helpers
# ---------------------------------------------------------------------------

def scan(table: str) -> Scan:
    return Scan(table)


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def scode(col: str, value: str) -> CodeLit:
    """Dictionary code literal: ``scode("n_name", "FRANCE")``."""
    return CodeLit(col, value)


def isin(a, values: Sequence) -> InSet:
    """Membership in a literal set of ints or ``scode`` values."""
    return InSet(_wrap(a), values)


def like(col: str, *subs: str) -> Like:
    return Like(col, subs)


def starts_with(col: str, prefix: str) -> StartsWith:
    return StartsWith(col, prefix)


def ends_with(col: str, suffix: str) -> EndsWith:
    return EndsWith(col, suffix)


def alpha_rank(col: str) -> AlphaRank:
    return AlphaRank(col)


def year(a) -> Year:
    return Year(_wrap(a))


def where(cond, a, b) -> Where:
    return Where(_wrap(cond), a, b)


def db_scale() -> DbScale:
    return DbScale()


def param(name: str, lo=None, hi=None, default=None,
          dtype: str | None = None) -> Param:
    """Template parameter placeholder with an optional provable domain:
    ``param("cutoff", lo=days("1998-08-03"), hi=days("1998-10-02"))``."""
    return Param(name, lo=lo, hi=hi, default=default, dtype=dtype)


def result(**exprs) -> ScalarResult:
    return ScalarResult(exprs)
