"""JCC-H-style skewed TPC-H variant (Boncz et al., drop-in schema-compatible).

JCC-H adds join-crossing correlations and heavy skew to TPC-H.  We reproduce
the property the paper exercises (§7.2): a small hot-key population receives a
large share of FK references, so (a) hash partitions are unbalanced across
devices, (b) shuffles develop per-node send/recv skew, and (c) some GPUs build
much larger hash tables.  The schema and queries are unchanged.
"""
from __future__ import annotations

from repro_torch.core.table import Database
from . import tpch

DEFAULT_SKEW = 0.25  # fraction of FK draws redirected to the hot population


def generate(scale: float, seed: int = 7, skew: float = DEFAULT_SKEW) -> Database:
    return tpch.generate(scale, seed=seed, skew=skew)
