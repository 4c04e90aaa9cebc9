"""SQL frontend: tokenizer, parser, binder/lowering, and IR optimizer.

Compiles a TPC-H-covering SQL subset into :mod:`repro_torch.core.plan` DAGs
that the existing planner/backends run unchanged.  ``compile_sql`` turns
ad-hoc SQL text into a :class:`repro_torch.core.planner.CompiledQuery`;
``sql_queries`` loads the committed TPC-H suite (``src/repro_torch/queries/sql/``), which
``REPRO_FRONTEND=sql`` swaps in for the hand-built plans engine-wide.  See
docs/ARCHITECTURE.md section 9 for the pass pipeline.
"""
from .frontend import compile_sql, plan_sql, sql_plans, sql_queries
from .lexer import SqlError
from .lower import lower
from .optimizer import optimize
from .parser import parse

__all__ = ["SqlError", "parse", "lower", "optimize", "plan_sql",
           "compile_sql", "sql_plans", "sql_queries"]
