"""SQL entry points: text -> logical plan -> compiled query.

``compile_sql`` is the one-call path (parse -> bind/lower -> optimize ->
``compile_query``); ``plan_sql`` stops at the logical-plan root for callers
that stage compilation themselves (``serve.PlanTemplate.from_sql``).  The
committed TPC-H SQL texts live in ``src/repro_torch/queries/sql/q*.sql`` (a
copy of the reference package's: the port reads only its own) and load
through ``sql_plans`` / ``sql_queries`` — ``REPRO_FRONTEND=sql`` swaps them
in for the hand-built plan DAGs in :mod:`repro_torch.queries`.
"""
from __future__ import annotations

import pathlib

from repro_torch.core.planner import CompiledQuery, compile_query

from .lower import lower
from .optimizer import optimize
from .parser import parse

__all__ = ["compile_sql", "plan_sql", "sql_plans", "sql_queries", "SQL_DIR"]

# the committed TPC-H SQL suite
SQL_DIR = pathlib.Path(__file__).resolve().parents[1] / "queries" / "sql"


def plan_sql(text: str):
    """Compile SQL ``text`` into an optimized logical-plan root."""
    return optimize(lower(parse(text)))


def compile_sql(text: str, name: str | None = None) -> CompiledQuery:
    """Compile SQL ``text`` into a runnable :class:`CompiledQuery`."""
    return compile_query(lambda: plan_sql(text), name=name or "sql")


def sql_text(qid: int) -> str:
    """The committed SQL text of TPC-H query ``qid``."""
    return (SQL_DIR / f"q{qid}.sql").read_text()


def sql_plans() -> dict:
    """qid -> fresh-plan build function for the committed TPC-H SQL texts."""
    out = {}
    for path in SQL_DIR.glob("q*.sql"):
        text = path.read_text()
        out[int(path.stem[1:])] = (lambda t: lambda: plan_sql(t))(text)
    return dict(sorted(out.items()))


def sql_queries() -> dict:
    """qid -> CompiledQuery for the committed TPC-H SQL texts."""
    return {qid: compile_query(fn, name=f"q{qid}")
            for qid, fn in sql_plans().items()}
