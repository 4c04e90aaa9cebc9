"""Approximate & progressive query answers.

A size ladder of stratified samples (:mod:`.sampling`), per-aggregate
scale-up + CLT error bars riding the partial-aggregate machinery
(:mod:`.estimators`), a planner pass rewriting aggregation plans onto a rung
(:mod:`.rewrite`, also reachable as ``CompiledQuery.approximate``), and a
progressive runner that climbs the ladder while the confidence interval
exceeds the caller's tolerance (:mod:`.progressive`;
``QueryServer.submit(tolerance=...)`` is the serving entry point).  The
port's own copy of the reference package's ``approx``: the same rows, the
same estimators and the same rewrites.
"""

from .estimators import ESTIMABLE_OPS, ApproxEstimate, finalize_result
from .progressive import ApproxAnswer, ProgressiveRunner, approx_default
from .rewrite import ApproxRewrite, rewrite_for_rung
from .sampling import DEFAULT_SEED, LADDER, rung_database, sample_table

__all__ = [
    "LADDER", "DEFAULT_SEED", "sample_table", "rung_database",
    "ESTIMABLE_OPS", "ApproxEstimate", "finalize_result",
    "ApproxRewrite", "rewrite_for_rung",
    "ApproxAnswer", "ProgressiveRunner", "approx_default",
]
