"""Scale-up rules and CLT error bars for sample-rewritten aggregations.

Estimability per aggregate op over a stratified sample whose strata are the
aggregation's own group keys (so each output group is exactly one stratum of
true size ``n``, pre-filter sample size ``m``, and post-filter sample count
``mf``):

* ``sum``   — estimable.  The rewrite emits ``sum(__sw * x)``; with the
  weight ``w = n/m`` constant per stratum that equals ``(n/m) * S1``.
* ``count`` — estimable.  The rewrite emits ``sum(__sw)`` = ``(n/m) * mf``.
* ``avg``   — estimable and *unscaled*: the plain sample mean is the
  estimator (self-weighting, because the weight is constant within the
  group), so the rewrite leaves ``avg`` aggregates untouched.
* ``min`` / ``max`` — **non-estimable**: an extreme that was not sampled is
  invisible and no CLT bar covers it.  The rewrite refuses and the query
  runs exact.

Variance rides the engine's own partial-aggregate machinery: the rewrite
injects moment columns (``__ap_n`` = max ``__sn``, ``__ap_m`` = max ``__sm``,
``__ap_mf`` = count(*), and per target ``__ap_s1_<name>`` = sum(x),
``__ap_s2_<name>`` = sum(x*x)) whose merge ops (sum/max) are exactly the ones
exchanges already combine, so error bars survive local/shuffle/gather
exchanges unchanged.  This module turns those moments into 95 % (by default)
normal-approximation intervals:

* sum:   ``s^2 = (S2 - S1^2/m) / (m-1)``;  ``Var = n^2 (1 - m/n) s^2 / m``
* count: a sum of 0/1 pass indicators — ``S1 = S2 = mf`` in the same formula
* avg:   ``s_x^2`` over the ``mf`` post-filter values; ``Var = s_x^2/mf *
  (1 - m/n)`` (the finite-population correction of the sampling stage)

Honesty gate: a group whose sample cannot support a variance estimate
(``m < 2``, or ``mf < 2`` for avg) reports an **infinite** half-width — it
can never satisfy a tolerance, which forces the progressive runner to climb.
A fully-sampled group (``m == n``) reports half-width 0.  Groups with no
post-filter sample rows are simply absent from the output — never fabricated
as zeros.  And a scale-rewritten result that arrives WITHOUT its moment
columns (a projection dropped them) makes :func:`finalize_result` raise —
a scaled (den > 1) estimate must never be reported as exact.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "ESTIMABLE_OPS",
    "MOMENT_PREFIX",
    "N_COL",
    "M_COL",
    "MF_COL",
    "s1_col",
    "s2_col",
    "z_value",
    "t_value",
    "point_estimate",
    "interval",
    "ApproxEstimate",
    "finalize_result",
]

ESTIMABLE_OPS = frozenset({"sum", "count", "avg"})

MOMENT_PREFIX = "__ap_"
N_COL = MOMENT_PREFIX + "n"    # true stratum size n (max of __sn)
M_COL = MOMENT_PREFIX + "m"    # pre-filter sample size m (max of __sm)
MF_COL = MOMENT_PREFIX + "mf"  # post-filter sample count (count(*))


def s1_col(name: str) -> str:
    return f"{MOMENT_PREFIX}s1_{name}"


def s2_col(name: str) -> str:
    return f"{MOMENT_PREFIX}s2_{name}"


# Two-sided normal quantiles; anything else falls back to scipy-free
# inversion via math.erf bisection (confidence levels used in anger are the
# tabulated ones).
_Z_TABLE = {0.90: 1.6448536269514722,
            0.95: 1.959963984540054,
            0.99: 2.5758293035489004}


def z_value(confidence: float = 0.95) -> float:
    z = _Z_TABLE.get(round(float(confidence), 6))
    if z is not None:
        return z
    p = (1.0 + float(confidence)) / 2.0
    lo, hi = 0.0, 10.0
    for _ in range(80):
        mid = (lo + hi) / 2.0
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < p:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


# Student-t two-sided critical values for df 1..30 (then the normal quantile
# is within 2%).  Stratified rungs routinely leave m = 2..5 rows per small
# stratum; a z-interval there badly undercovers — the coverage harness in
# tests/test_approx.py is what forced the t correction.
_T_TABLES = {
    0.90: (6.314, 2.920, 2.353, 2.132, 2.015, 1.943, 1.895, 1.860, 1.833,
           1.812, 1.796, 1.782, 1.771, 1.761, 1.753, 1.746, 1.740, 1.734,
           1.729, 1.725, 1.721, 1.717, 1.714, 1.711, 1.708, 1.706, 1.703,
           1.701, 1.699, 1.697),
    0.95: (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
           2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
           2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
           2.048, 2.045, 2.042),
    0.99: (63.657, 9.925, 5.841, 4.604, 4.032, 3.707, 3.499, 3.355, 3.250,
           3.169, 3.106, 3.055, 3.012, 2.977, 2.947, 2.921, 2.898, 2.878,
           2.861, 2.845, 2.831, 2.819, 2.807, 2.797, 2.787, 2.779, 2.771,
           2.763, 2.756, 2.750),
}


def t_value(df, confidence: float = 0.95):
    """Vectorized two-sided critical value: Student-t for small df, normal
    beyond the table (df >= 31), normal for untabulated confidences."""
    df = np.asarray(df)
    z = z_value(confidence)
    tab = _T_TABLES.get(round(float(confidence), 6))
    if tab is None:
        return np.full(df.shape, z, dtype=np.float64)
    tab = np.asarray(tab, dtype=np.float64)
    idx = np.clip(df, 1, 30).astype(np.int64) - 1
    return np.where(df >= 31, z, tab[idx])


def point_estimate(op, n, m, mf, s1):
    """Scale-up point estimate from the moments (mirrors the plan rewrite)."""
    n = np.asarray(n, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    mf = np.asarray(mf, dtype=np.float64)
    s1 = np.asarray(s1, dtype=np.float64)
    if op == "sum":
        return n / m * s1
    if op == "count":
        return n / m * mf
    if op == "avg":
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(mf > 0, s1 / np.maximum(mf, 1.0), np.nan)
    raise ValueError(f"non-estimable aggregate op {op!r}")


def interval(op, n, m, mf, s1, s2, confidence: float = 0.95):
    """Vectorized ``(estimate, half_width)`` for one aggregate column.

    Inputs are per-group moment arrays (broadcastable scalars accepted).
    Half-width is ``inf`` where the sample cannot support a variance estimate
    and ``0`` where the stratum was fully sampled (``m >= n``).
    """
    if op not in ESTIMABLE_OPS:
        raise ValueError(f"non-estimable aggregate op {op!r}")
    n = np.asarray(n, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    mf = np.asarray(mf, dtype=np.float64)
    if op == "count":
        s1 = mf
        s2 = mf
    s1 = np.asarray(s1, dtype=np.float64)
    s2 = np.asarray(s2, dtype=np.float64)
    est = point_estimate(op, n, m, mf, s1)
    fpc = np.maximum(0.0, 1.0 - m / np.maximum(n, 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "avg":
            crit = t_value(mf - 1, confidence)
            s2x = (s2 - s1 * s1 / np.maximum(mf, 1.0)) / np.maximum(mf - 1.0, 1.0)
            var = np.maximum(s2x, 0.0) / np.maximum(mf, 1.0) * fpc
            hw = crit * np.sqrt(var)
            hw = np.where(mf > 1, hw, np.inf)
        else:
            crit = t_value(m - 1, confidence)
            s2v = (s2 - s1 * s1 / np.maximum(m, 1.0)) / np.maximum(m - 1.0, 1.0)
            var = n * n * fpc * np.maximum(s2v, 0.0) / np.maximum(m, 1.0)
            hw = crit * np.sqrt(var)
            hw = np.where(m > 1, hw, np.inf)
    hw = np.where(m >= n, 0.0, hw)  # fully-sampled stratum is exact
    return est, hw


def _rel_width(est: np.ndarray, hw: np.ndarray) -> np.ndarray:
    """Relative half-width: hw/|est|, 0 when both are 0, inf when only est is."""
    est = np.asarray(est, dtype=np.float64)
    hw = np.asarray(hw, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(est != 0.0, hw / np.abs(est),
                       np.where(hw == 0.0, 0.0, np.inf))
    return rel


@dataclasses.dataclass
class ApproxEstimate:
    """A finalized approximate answer: clean columns + its error bars."""

    result: dict        # moment columns stripped; target columns are estimates
    half_width: dict    # target name -> per-group absolute CI half-width
    rel_width: float    # max relative half-width over all groups and targets
    confidence: float

    @property
    def exact(self) -> bool:
        return self.rel_width == 0.0


def finalize_result(cols, targets, confidence: float = 0.95,
                    scaled: bool = False) -> ApproxEstimate:
    """Turn a raw rewritten-query result into estimates with error bars.

    ``cols`` is the numpy result dict of the rewritten plan; ``targets`` is
    the rewrite's list of ``(name, op)`` pairs.  ``scaled`` says the targets
    were scale-rewritten (``den > 1``): then the moment columns MUST be
    present for every served target — a result that lost them (a projection
    the rewrite failed to guard) raises rather than masquerade a
    Horvitz-Thompson estimate as an exact zero-width answer.  With
    ``scaled=False`` a result without moment columns (the rung-1 / refused
    case) is passed through exact with zero width.  Scalar results arrive as
    length-1 arrays and need no special casing.
    """
    cols = {k: np.asarray(v) for k, v in cols.items()}
    if N_COL not in cols:
        if scaled:
            raise ValueError(
                "approx: targets were scale-rewritten but the __ap_* moment "
                "columns are missing from the result — a projection dropped "
                "them; refusing to report a scaled estimate as exact")
        clean = {k: v for k, v in cols.items()
                 if not k.startswith(MOMENT_PREFIX)}
        return ApproxEstimate(clean, {t[0]: np.zeros(0) for t in targets},
                              0.0, confidence)
    n, m, mf = cols[N_COL], cols[M_COL], cols[MF_COL]
    half = {}
    worst = 0.0
    for name, op in targets:
        if name not in cols:
            continue   # a projection dropped this target: it is not served
        s1 = cols.get(s1_col(name))
        s2 = cols.get(s2_col(name))
        if s1 is None and op != "count":
            if scaled:
                raise ValueError(
                    f"approx: scaled target {name!r} is served but its "
                    f"__ap_s1/__ap_s2 moments were projected away — no "
                    f"error bar is attachable")
            continue   # moments projected away: no bar attachable
        est, hw = interval(op, n, m, mf, s1, s2, confidence)
        half[name] = hw
        rel = _rel_width(cols[name], hw)
        if rel.size:
            worst = max(worst, float(np.max(rel)))
    clean = {k: v for k, v in cols.items() if not k.startswith(MOMENT_PREFIX)}
    return ApproxEstimate(clean, half, worst, confidence)
