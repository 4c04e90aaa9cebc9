"""The comparison that decides ``correct``: a served answer against the
reference's answer to the same request.

Two numbers come out of one comparison:

* ``wrong`` counts what must match exactly and does not: a missing column,
  a difference in the number of rows, a row whose integer columns (keys,
  codes, counts, dates) differ, and a pair of neighbouring rows in the
  served order that breaks the query's ORDER BY.  Its limit is 0.
* ``gap`` is the widest gap of a float column, as a share of the largest
  magnitude the reference's column holds (column by column, so a sum near
  zero is judged against its column, not against itself).

Rows are matched by their integer columns, both sides sorted on them, so
that rows which the ORDER BY leaves tied may come in either order; the
order itself is checked apart, on the served rows.
"""
from __future__ import annotations

import numpy as np

__all__ = ["compare"]


def _exact(a: np.ndarray) -> bool:
    return a.dtype.kind in "biu"


def _ordered(got: dict, keys, limit: float) -> int:
    """Neighbouring served rows that break ``keys``; float keys closer
    than ``limit`` of their column's largest magnitude count as ties."""
    n = len(next(iter(got.values()))) if got else 0
    if n < 2 or not keys:
        return 0
    undecided = np.ones(n - 1, dtype=bool)
    bad = np.zeros(n - 1, dtype=bool)
    for col, asc in keys:
        v = np.asarray(got[col])
        a, b = v[:-1], v[1:]
        if _exact(v):
            a, b = a.astype(np.int64), b.astype(np.int64)
            tie = a == b
        else:
            a, b = a.astype(np.float64), b.astype(np.float64)
            scale = max(float(np.max(np.abs(v))), np.finfo(float).tiny)
            tie = np.abs(a - b) <= limit * scale
        worse = (a > b) if asc else (a < b)
        bad |= undecided & ~tie & worse
        undecided &= tie
    return int(bad.sum())


def compare(got: dict, ref: dict, keys=(), limit: float = 0.0
            ) -> tuple[int, float]:
    """``(wrong, gap)`` of a served answer ``got`` against ``ref``, both
    column name -> numpy column; ``keys`` is the query's ORDER BY and
    ``limit`` the float limit, used only to tell ties in it."""
    n_ref = len(next(iter(ref.values()))) if ref else 0
    missing = [c for c in ref if c not in got]
    if missing:
        return max(1, n_ref), 0.0
    n_got = len(next(iter(got.values()))) if got else 0
    if n_got != n_ref:
        return max(1, abs(n_got - n_ref)), 0.0
    wrong = _ordered(got, keys, limit)
    exact = [c for c in ref if _exact(np.asarray(ref[c]))]
    if exact and n_ref:
        def rows(t):
            return np.lexsort([np.asarray(t[c]).astype(np.int64)
                               for c in reversed(exact)])
        g_at, r_at = rows(got), rows(ref)
    else:
        g_at = r_at = np.arange(n_ref)
    mism = np.zeros(n_ref, dtype=bool)
    gap = 0.0
    for c in ref:
        r = np.asarray(ref[c])[r_at]
        g = np.asarray(got[c])[g_at]
        if c in exact:
            if not _exact(g):
                return max(1, n_ref), 0.0
            mism |= r.astype(np.int64) != g.astype(np.int64)
            continue
        r, g = r.astype(np.float64), g.astype(np.float64)
        both_nan = np.isnan(r) & np.isnan(g)
        d = np.where(both_nan, 0.0, np.abs(g - r))
        if n_ref == 0:
            continue
        if np.isnan(d).any():
            return max(1, n_ref), float("inf")
        scale = float(np.max(np.abs(np.where(both_nan, 0.0, r))))
        gap = max(gap, float(np.max(d)) / scale if scale > 0
                  else float(np.max(d)))
    return wrong + int(mism.sum()), gap
