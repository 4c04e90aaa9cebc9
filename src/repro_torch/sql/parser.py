"""Recursive-descent parser for the TPC-H-covering SQL subset.

Grammar (roughly)::

    query     := declare* [WITH ctes] select
    declare   := DECLARE name type DEFAULT expr IN ( expr , expr ) ;
    select    := SELECT [hints] items FROM from_list [WHERE expr]
                 [GROUP BY exprs] [HAVING expr] [ORDER BY orders] [LIMIT n]
    from_item := table_ref { [LEFT [OUTER]] JOIN table_ref ON expr }
    expr      := OR / AND / NOT / comparison / IN / BETWEEN / LIKE / EXISTS
                 / + - * / / unary minus / CASE / functions / subqueries

Optimizer hints ride in ``/*+ ... */`` tokens: after SELECT they attach to
the select (``groups(N)``); after a predicate they attach to that conjunct
(``shrink(N)``).  All errors are :class:`SqlError` with line/col.
"""
from __future__ import annotations

from . import ast as A
from .lexer import SqlError, Token, tokenize

__all__ = ["parse", "parse_expr", "parse_select"]

_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}
_AGG_FUNCS = {"sum", "count", "min", "max", "avg"}


class _Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # ------------------------------------------------------------ plumbing
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def err(self, msg: str, tok: Token | None = None) -> SqlError:
        tok = tok or self.cur
        return SqlError(msg, tok.line, tok.col)

    def advance(self) -> Token:
        tok = self.cur
        if tok.kind != "EOF":
            self.i += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        return self.cur.kind == "KEYWORD" and self.cur.value in words

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "OP" and self.cur.value in ops

    def eat_kw(self, word: str) -> bool:
        if self.at_kw(word):
            self.advance()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.eat_kw(word):
            raise self.err(f"expected {word.upper()}, "
                           f"got {self.cur.value or self.cur.kind!r}")

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.advance()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise self.err(f"expected {op!r}, "
                           f"got {self.cur.value or self.cur.kind!r}")

    def name(self, what: str = "name") -> str:
        if self.cur.kind != "NAME":
            raise self.err(f"expected {what}, "
                           f"got {self.cur.value or self.cur.kind!r}")
        return self.advance().value

    # --------------------------------------------------------------- query
    def parse_query(self) -> A.Query:
        declares = []
        while self.at_kw("declare"):
            declares.append(self.declare())
        ctes: list[tuple[str, A.Select]] = []
        if self.eat_kw("with"):
            while True:
                name = self.name("CTE name")
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.select()))
                self.expect_op(")")
                if not self.eat_op(","):
                    break
        body = self.select()
        self.eat_op(";")
        if self.cur.kind != "EOF":
            raise self.err(f"unexpected trailing input "
                           f"{self.cur.value or self.cur.kind!r}")
        return A.Query(body, tuple(ctes), tuple(declares))

    def declare(self) -> A.Declare:
        self.expect_kw("declare")
        name = self.name("parameter name")
        if self.at_kw("int", "float", "date"):
            dtype = self.advance().value
        else:
            raise self.err("expected parameter type (INT, FLOAT or DATE)")
        self.expect_kw("default")
        default = self.additive()
        self.expect_kw("in")
        self.expect_op("(")
        lo = self.additive()
        self.expect_op(",")
        hi = self.additive()
        self.expect_op(")")
        self.expect_op(";")
        return A.Declare(name, dtype, lo, hi, default)

    def hint_list(self) -> list[tuple[str, int]]:
        hints = []
        while self.cur.kind == "HINT":
            text = self.advance().value
            try:
                fn, rest = text.split("(", 1)
                n = int(rest.rstrip().rstrip(")"))
            except ValueError:
                raise self.err(f"malformed hint {text!r}",
                               self.toks[self.i - 1]) from None
            if fn.strip() not in ("groups", "shrink"):
                raise self.err(f"unknown hint {fn.strip()!r}",
                               self.toks[self.i - 1])
            hints.append((fn.strip(), n))
        return hints

    def select(self) -> A.Select:
        self.expect_kw("select")
        hints = self.hint_list()
        if self.eat_kw("distinct"):
            raise self.err("unsupported syntax: SELECT DISTINCT (use GROUP "
                           "BY, or COUNT(DISTINCT ...) for counts)",
                           self.toks[self.i - 1])
        items = [self.select_item()]
        while self.eat_op(","):
            items.append(self.select_item())
        self.expect_kw("from")
        frm = [self.from_item()]
        while self.eat_op(","):
            frm.append(self.from_item())
        where = self.expr() if self.eat_kw("where") else None
        group: list[A.Expr] = []
        having = None
        if self.eat_kw("group"):
            self.expect_kw("by")
            group.append(self.expr())
            while self.eat_op(","):
                group.append(self.expr())
        if self.eat_kw("having"):
            having = self.expr()
        order: list[tuple[A.Expr, bool]] = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                asc = True
                if self.eat_kw("desc"):
                    asc = False
                else:
                    self.eat_kw("asc")
                order.append((e, asc))
                if not self.eat_op(","):
                    break
        limit = None
        if self.eat_kw("limit"):
            tok = self.cur
            if tok.kind != "NUMBER":
                raise self.err("expected integer after LIMIT")
            self.advance()
            limit = int(tok.value)
        return A.Select(tuple(items), tuple(frm), where, tuple(group),
                        having, tuple(order), limit, tuple(hints))

    def select_item(self) -> A.SelectItem:
        e = self.expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.name("alias")
        elif self.cur.kind == "NAME":
            alias = self.advance().value
        return A.SelectItem(e, alias)

    def table_ref(self) -> "A.Table | A.Derived":
        if self.eat_op("("):
            sel = self.select()
            self.expect_op(")")
            self.eat_kw("as")
            return A.Derived(sel, self.name("derived-table alias"))
        tok = self.cur
        name = self.name("table name")
        alias = None
        if self.eat_kw("as"):
            alias = self.name("alias")
        elif self.cur.kind == "NAME":
            alias = self.advance().value
        return A.Table(name, alias, pos=(tok.line, tok.col))

    def from_item(self) -> A.FromItem:
        ref = self.table_ref()
        joins = []
        while True:
            if self.at_kw("join", "inner"):
                self.eat_kw("inner")
                self.expect_kw("join")
                kind = "inner"
            elif self.at_kw("left"):
                self.advance()
                self.eat_kw("outer")
                self.expect_kw("join")
                kind = "left"
            else:
                break
            right = self.table_ref()
            self.expect_kw("on")
            joins.append(A.JoinStep(kind, right, self.expr()))
        return A.FromItem(ref, tuple(joins))

    # --------------------------------------------------------- expressions
    def expr(self) -> A.Expr:
        return self.or_expr()

    def _hinted(self, e: A.Expr) -> A.Expr:
        if self.cur.kind == "HINT":
            return A.Hinted(e, tuple(self.hint_list()))
        return e

    def or_expr(self) -> A.Expr:
        e = self.and_expr()
        while self.at_kw("or"):
            self.advance()
            e = self._hinted(A.Binary("or", e, self.and_expr()))
        return e

    def and_expr(self) -> A.Expr:
        e = self.not_expr()
        while self.at_kw("and"):
            self.advance()
            e = A.Binary("and", e, self.not_expr())
            e = self._hinted(e)
        return e

    def not_expr(self) -> A.Expr:
        if self.at_kw("not"):
            tok = self.advance()
            if self.at_kw("exists"):
                ex = self.not_expr()
                assert isinstance(ex, A.ExistsE)
                return self._hinted(A.ExistsE(ex.query, negated=True))
            del tok
            return self._hinted(A.Unary("not", self.not_expr()))
        if self.at_kw("exists"):
            self.advance()
            self.expect_op("(")
            sel = self.select()
            self.expect_op(")")
            return self._hinted(A.ExistsE(sel))
        return self.predicate()

    def predicate(self) -> A.Expr:
        e = self.additive()
        while True:
            if self.cur.kind == "OP" and self.cur.value in _CMP_OPS:
                op = self.advance().value
                e = A.Binary(op, e, self.additive())
                continue
            negated = False
            if self.at_kw("not"):
                # NOT here must precede IN / BETWEEN / LIKE
                save = self.i
                self.advance()
                if self.at_kw("in", "between", "like"):
                    negated = True
                else:
                    self.i = save
                    break
            if self.eat_kw("between"):
                lo = self.additive()
                self.expect_kw("and")
                e = A.Between(e, lo, self.additive(), negated)
                continue
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    sel = self.select()
                    self.expect_op(")")
                    e = A.InQuery(e, sel, negated)
                else:
                    items = [self.additive()]
                    while self.eat_op(","):
                        items.append(self.additive())
                    self.expect_op(")")
                    e = A.InList(e, tuple(items), negated)
                continue
            if self.eat_kw("like"):
                tok = self.cur
                if tok.kind != "STRING":
                    raise self.err("LIKE pattern must be a string literal")
                self.advance()
                e = A.LikeE(e, tok.value, negated)
                continue
            if self.at_kw("is"):
                raise self.err("unsupported syntax: IS [NOT] NULL (the "
                               "engine's LEFT JOIN defaults make columns "
                               "non-null)")
            break
        return self._hinted(e)

    def additive(self) -> A.Expr:
        e = self.multiplicative()
        while self.at_op("+", "-"):
            op = self.advance().value
            e = A.Binary(op, e, self.multiplicative())
        return e

    def multiplicative(self) -> A.Expr:
        e = self.unary()
        while self.at_op("*", "/"):
            op = self.advance().value
            e = A.Binary(op, e, self.unary())
        return e

    def unary(self) -> A.Expr:
        if self.at_op("-"):
            self.advance()
            return A.Unary("-", self.unary())
        return self.primary()

    def primary(self) -> A.Expr:
        tok = self.cur
        if tok.kind == "NUMBER":
            self.advance()
            is_float = any(c in tok.value for c in ".eE")
            return A.Number(float(tok.value) if is_float else int(tok.value))
        if tok.kind == "STRING":
            self.advance()
            return A.String(tok.value)
        if tok.kind == "PARAM":
            self.advance()
            return A.ParamE(tok.value)
        if self.at_op("*"):
            self.advance()
            return A.Star()
        if self.at_kw("date"):
            self.advance()
            if self.cur.kind != "STRING":
                raise self.err("expected 'YYYY-MM-DD' after DATE")
            return A.DateL(self.advance().value)
        if self.at_kw("interval"):
            self.advance()
            if self.cur.kind != "STRING":
                raise self.err("expected quoted count after INTERVAL")
            n = int(self.advance().value)
            if not self.at_kw("day", "month", "year"):
                raise self.err("expected DAY, MONTH or YEAR")
            return A.IntervalL(n, self.advance().value)
        if self.at_kw("case"):
            return self.case()
        if self.at_kw("extract"):
            self.advance()
            self.expect_op("(")
            self.expect_kw("year")
            self.expect_kw("from")
            e = self.expr()
            self.expect_op(")")
            return A.Func("year", (e,))
        if self.at_kw("cast"):
            raise self.err("unsupported syntax: CAST (the binder types "
                           "expressions automatically)")
        if self.at_kw(*_AGG_FUNCS) or self.at_kw("year"):
            fn = self.advance().value
            self.expect_op("(")
            distinct = bool(self.eat_kw("distinct"))
            if fn == "count" and self.at_op("*"):
                self.advance()
                args: tuple[A.Expr, ...] = (A.Star(),)
            else:
                args = (self.expr(),)
            self.expect_op(")")
            return A.Func(fn, args, distinct)
        if tok.kind == "NAME":
            self.advance()
            if self.eat_op("("):
                args = []
                if not self.at_op(")"):
                    args.append(self.expr())
                    while self.eat_op(","):
                        args.append(self.expr())
                self.expect_op(")")
                return A.Func(tok.value.lower(), tuple(args))
            if self.eat_op("."):
                return A.Ident(self.name("column name"), tok.value,
                               pos=(tok.line, tok.col))
            return A.Ident(tok.value, pos=(tok.line, tok.col))
        if self.eat_op("("):
            if self.at_kw("select"):
                sel = self.select()
                self.expect_op(")")
                return A.Scalar(sel)
            e = self.expr()
            self.expect_op(")")
            return e
        raise self.err(f"unexpected {tok.value or tok.kind!r} in expression",
                       tok)

    def case(self) -> A.Expr:
        self.expect_kw("case")
        whens = []
        while self.eat_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        if not whens:
            raise self.err("CASE requires at least one WHEN")
        default = self.expr() if self.eat_kw("else") else None
        self.expect_kw("end")
        return A.CaseE(tuple(whens), default)


def parse(text: str) -> A.Query:
    """Parse a full statement (declares + optional WITH + select)."""
    return _Parser(text).parse_query()


def parse_select(text: str) -> A.Select:
    p = _Parser(text)
    sel = p.select()
    p.eat_op(";")
    if p.cur.kind != "EOF":
        raise p.err(f"unexpected trailing input "
                    f"{p.cur.value or p.cur.kind!r}")
    return sel


def parse_expr(text: str) -> A.Expr:
    """Parse a standalone expression (hypothesis round-trip entry point)."""
    p = _Parser(text)
    e = p.expr()
    if p.cur.kind != "EOF":
        raise p.err(f"unexpected trailing input "
                    f"{p.cur.value or p.cur.kind!r}")
    return e
