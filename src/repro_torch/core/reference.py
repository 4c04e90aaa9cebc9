"""NumPy reference executor — independent oracle + the paper's CPU baseline.

Implements the same relational API as :mod:`repro_torch.core.relational` but with
exact-size arrays and *different* algorithms (boolean indexing, ``np.unique``
based group-by, dictionary-free joins) so that agreement with the JAX engine is
meaningful validation, not shared bugs.  Also serves as the single-node CPU
baseline for the paper's DuckDB comparison (§6.7).

Tables here are plain ``dict[str, np.ndarray]`` with no padding.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

RTable = dict  # dict[str, np.ndarray]


def filter_rows(t: RTable, mask: np.ndarray) -> RTable:
    return {k: v[mask] for k, v in t.items()}


def limit(t: RTable, n: int) -> RTable:
    return {k: v[:n] for k, v in t.items()}


def _nrows(t: RTable) -> int:
    return len(next(iter(t.values())))


def combine_keys(cols: Sequence[np.ndarray]) -> np.ndarray:
    if len(cols) > 2:
        raise ValueError("pack >2 keys explicitly in the plan (collision safety)")
    k = cols[0].astype(np.int64)
    for c in cols[1:]:
        k = (k << 32) | c.astype(np.int64)
    return k


def join_unique(probe: RTable, build: RTable, probe_on: np.ndarray,
                build_on: np.ndarray, take: Sequence[str]) -> RTable:
    build_on = np.asarray(build_on, dtype=np.int64)
    if len(np.unique(build_on)) != len(build_on):
        raise ValueError("build side keys are not unique")
    lut = {int(k): i for i, k in enumerate(build_on)}
    idx = np.array([lut.get(int(k), -1) for k in probe_on], dtype=np.int64)
    matched = idx >= 0
    out = {k: v[matched] for k, v in probe.items()}
    for name in take:
        out[name] = build[name][idx[matched]]
    return out


def semi_join(probe: RTable, build: RTable, probe_on, build_on) -> RTable:
    keys = set(np.asarray(build_on, dtype=np.int64).tolist())
    matched = np.array([int(k) in keys for k in probe_on], dtype=bool)
    return filter_rows(probe, matched)


def anti_join(probe: RTable, build: RTable, probe_on, build_on) -> RTable:
    keys = set(np.asarray(build_on, dtype=np.int64).tolist())
    matched = np.array([int(k) in keys for k in probe_on], dtype=bool)
    return filter_rows(probe, ~matched)


def left_join(probe: RTable, build: RTable, probe_on, build_on,
              take: Sequence[str], defaults) -> RTable:
    build_on = np.asarray(build_on, dtype=np.int64)
    lut = {int(k): i for i, k in enumerate(build_on)}
    idx = np.array([lut.get(int(k), -1) for k in probe_on], dtype=np.int64)
    matched = idx >= 0
    out = dict(probe)
    for name in take:
        col = build[name]
        vals = np.full(len(idx), defaults[name], dtype=col.dtype)
        vals[matched] = col[idx[matched]]
        out[name] = vals
    out["__matched"] = matched
    return out


def group_aggregate(t: RTable, key_cols: Sequence[str],
                    aggs: Sequence[tuple[str, str, np.ndarray | str | None]]) -> RTable:
    n = _nrows(t)
    if key_cols:
        key = combine_keys([t[k] for k in key_cols])
    else:
        key = np.zeros(n, dtype=np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    g = len(uniq)
    out: RTable = {}
    for k in key_cols:
        first = np.zeros(g, dtype=np.int64)
        # last writer wins; all rows in a group share the key value
        first[inv] = np.arange(n)
        out[k] = t[k][first]
    for out_name, op, values in aggs:
        if values is None:
            v = np.ones(n, dtype=np.int64)
        elif isinstance(values, str):
            v = t[values]
        else:
            v = np.asarray(values)
        if op == "count":
            out[out_name] = np.bincount(inv, minlength=g).astype(np.int64)
        elif op == "sum":
            out[out_name] = np.bincount(inv, weights=v.astype(np.float64), minlength=g) \
                if np.issubdtype(v.dtype, np.floating) else \
                np.bincount(inv, weights=v.astype(np.float64), minlength=g).astype(np.int64)
        elif op == "min":
            acc = np.full(g, np.inf if np.issubdtype(v.dtype, np.floating)
                          else np.iinfo(v.dtype).max, dtype=v.dtype)
            np.minimum.at(acc, inv, v)
            out[out_name] = acc
        elif op == "max":
            acc = np.full(g, -np.inf if np.issubdtype(v.dtype, np.floating)
                          else np.iinfo(v.dtype).min, dtype=v.dtype)
            np.maximum.at(acc, inv, v)
            out[out_name] = acc
        else:
            raise ValueError(op)
    if g == 0:  # preserve dtypes for empty results
        for out_name, op, values in aggs:
            if out_name not in out:
                out[out_name] = np.zeros(0)
    return out


def sort_by(t: RTable, keys: Sequence[tuple[str, bool]]) -> RTable:
    order = np.arange(_nrows(t))
    for col, asc in reversed(list(keys)):
        k = t[col][order]
        k = k if asc else (-k if np.issubdtype(k.dtype, np.number) else k)
        step = np.argsort(k, kind="stable")
        order = order[step]
    return {k: v[order] for k, v in t.items()}
