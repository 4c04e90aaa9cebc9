"""Stratified sample ladder over ``Database`` fact tables.

A *rung* is a stratified sample of one fact table at ratio ``1/den`` for
``den`` in the :data:`LADDER` (16, 8, 4, 2, 1).  Row selection is a
deterministic seeded hash rank: every row gets a 64-bit splitmix hash of its
global row index, and within each stratum the ``m_g = max(1, ceil(n_g/den))``
smallest hashes are kept.  Two consequences the estimators and tests rely on:

* **min-1 stratification** — every stratum (the aggregation's group keys, as
  reported by the rewrite pass) keeps at least one row, so small groups
  survive downsampling instead of silently vanishing;
* **nesting** — the hash order does not depend on ``den``, so the rung-16
  sample is a subset of rung 8, which is a subset of rung 4, and so on up to
  rung 1 (the full table).  Escalating a rung only *adds* evidence.

Sample tables carry three bookkeeping columns next to the original ones
(row order preserved):

* ``__sw`` (float64) — the Horvitz-Thompson scale-up weight ``n_g / m_g``,
  constant within a stratum;
* ``__sm`` (int64) — the pre-filter stratum sample size ``m_g``;
* ``__sn`` (int64) — the true stratum size ``n_g``.

Rung databases are cached per source ``Database`` and evicted through the
planner invalidation registry, exactly like ``serve.cache.PlanCache``:
``planner.invalidate_stats(db)`` (or a ``stats_override`` exit) drops every
rung derived from ``db``, and with it the rung's device tables and shards.

On the card a rung database holds the base's resident tensors (the same
objects) beside its one sample table
(:func:`repro_torch.core.backend.derive_database`): a rung uploads only its
sample, once per (table, strata, den, seed), never the base again.  The
rows selected are the reference's, row for row: the hash rank is its
``np.lexsort``, and only the numbering of the strata differs (1-D codes in
place of ``np.unique(axis=0)``, the same ids).
"""

from __future__ import annotations

import weakref

import numpy as np

from repro_torch.core import planner
from repro_torch.core.plan import (SAMPLE_M_COL, SAMPLE_N_COL,
                                   SAMPLE_WEIGHT_COL)
from repro_torch.core.table import Database

__all__ = [
    "LADDER",
    "DEFAULT_SEED",
    "rung_name",
    "stratified_selection",
    "sample_table",
    "rung_database",
    "invalidate",
]

# Denominators, largest (smallest sample) first: the progressive runner climbs
# this left to right.  The final rung 1 is the full table — exact by
# construction, which is what makes the ladder a terminating protocol.
LADDER = (16, 8, 4, 2, 1)

# Fixed default so every layer (rewrite, serve, benchmarks, tests) lands on
# the same cached rung unless a caller deliberately varies the seed.
DEFAULT_SEED = 0x5EED


def rung_name(table: str, den: int) -> str:
    """Name of the rung table derived from ``table`` at ratio ``1/den``."""
    return f"{table}__r{int(den)}"


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — a deterministic 64-bit mix per row index."""
    z = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        z += np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


def _stratum_ids(strata, n_rows: int) -> np.ndarray:
    """Each row's stratum id, strata numbered in the lexicographic order of
    their key rows: ``np.unique(axis=0)``'s inverse, through 1-D codes.

    Each column's rank among its own values folds into the ids so far in
    mixed radix, renumbered after every column so the code stays below
    ``n_rows ** 2``.  The reference's ``np.unique(axis=0)`` sorts the key
    rows as structured records, the slowest part of its selection at SF
    10's 60 M rows (``tools/time_sampling.py`` times the parts)."""
    if not strata:
        return np.zeros(n_rows, dtype=np.int64)
    ranks = [np.unique(np.asarray(c).astype(np.int64), return_inverse=True)
             for c in strata]
    sid = ranks[0][1].reshape(-1)
    for vals, rank in ranks[1:]:
        sid = np.unique(sid * vals.size + rank.reshape(-1),
                        return_inverse=True)[1].reshape(-1)
    return sid


def stratified_selection(strata, n_rows, den, seed=DEFAULT_SEED):
    """Pick rows for one rung.

    ``strata`` is a sequence of integer numpy columns (possibly empty for a
    single global stratum).  Returns ``(mask, sid, n_g, m_g)`` where ``mask``
    is the boolean keep-mask over the ``n_rows`` input rows, ``sid`` maps each
    row to its stratum id, and ``n_g`` / ``m_g`` are per-stratum population
    and sample sizes indexed by stratum id.
    """
    den = int(den)
    if den < 1:
        raise ValueError(f"ladder denominator must be >= 1, got {den}")
    sid = _stratum_ids(strata, n_rows)
    n_g = np.bincount(sid)
    m_g = np.maximum(1, -(-n_g // den))  # ceil(n_g / den), floor 1
    # Per-row hash is a pure function of (seed, global row index): the same
    # row ranks identically at every den, which is what nests the rungs.
    mixed_seed = np.uint64((int(seed) * 0x2545F4914F6CDD1D) % (1 << 64))
    with np.errstate(over="ignore"):
        h = _splitmix64(np.arange(n_rows, dtype=np.uint64) + mixed_seed)
    # group by stratum, hash-ranked within; the ids in their narrowest
    # dtype, the same order, which numpy's stable sort takes by radix
    key = sid.astype(np.min_scalar_type(max(n_g.size - 1, 0)))
    order = np.lexsort((h, key))
    starts = np.concatenate(([0], np.cumsum(n_g)))
    rank = np.empty(n_rows, dtype=np.int64)
    rank[order] = np.arange(n_rows, dtype=np.int64) - \
        np.repeat(starts[:-1], n_g)
    mask = rank < m_g[sid]
    return mask, sid, n_g, m_g


def sample_table(table_cols, strata_names, den, seed=DEFAULT_SEED):
    """Materialize one rung of a plain-numpy table dict.

    Keeps the original row order (boolean-mask selection) and appends the
    ``__sw`` / ``__sm`` / ``__sn`` bookkeeping columns.  ``strata_names``
    must name integer columns of the table; an empty tuple means one global
    stratum (the scalar-aggregate case).
    """
    cols = {c: np.asarray(v) for c, v in table_cols.items()}
    n_rows = len(next(iter(cols.values()))) if cols else 0
    for s in strata_names:
        if s not in cols:
            raise KeyError(f"stratum column {s!r} not in table")
        if cols[s].dtype.kind not in "iu":
            raise TypeError(f"stratum column {s!r} must be integer-typed")
    mask, sid, n_g, m_g = stratified_selection(
        [cols[s] for s in strata_names], n_rows, den, seed)
    out = {c: v[mask] for c, v in cols.items()}
    ssel = sid[mask]
    out[SAMPLE_WEIGHT_COL] = (n_g[ssel] / m_g[ssel]).astype(np.float64)
    out[SAMPLE_M_COL] = m_g[ssel].astype(np.int64)
    out[SAMPLE_N_COL] = n_g[ssel].astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# Rung-database cache, evicted through the planner invalidation registry
# (same pattern as serve.cache.PlanCache: keyed on id(db) with a weakref
# guard against id reuse, dropped by planner.invalidate_stats).

_RUNGS: dict = {}  # (id(db), table, strata, den, seed) -> (weakref(db), rung_db)


def _drop_rung_partition_keys(dead_keys) -> None:
    """Unregister ``backend.PARTITION_KEYS`` entries for invalidated rungs.

    A rung name may be shared by rungs of other live databases (same table
    and den, different ``Database``); the entry stays until the last one is
    evicted — the registered value is the base table's key either way."""
    if not dead_keys:
        return
    from repro_torch.core import backend as B
    live = {rung_name(k[1], k[3]) for k in _RUNGS}
    for k in dead_keys:
        name = rung_name(k[1], k[3])
        if name not in live:
            B.PARTITION_KEYS.pop(name, None)


def _invalidation_hook(db) -> None:
    dead = [k for k, (ref, _) in _RUNGS.items()
            if k[0] == id(db) or ref() is None]
    rdbs = [_RUNGS.pop(k)[1] for k in dead]
    _drop_rung_partition_keys(dead)
    # the rungs' own caches (device tables and shards among them) go too: a
    # caller still holding a rung must not keep its sample on the card
    for rdb in rdbs:
        planner.invalidate_stats(rdb)


planner.register_invalidation(_invalidation_hook)


def invalidate(db=None) -> None:
    """Drop cached rungs for ``db`` (or all rungs when ``db`` is None)."""
    if db is None:
        dead = list(_RUNGS)
        rdbs = [rdb for _, rdb in _RUNGS.values()]
        _RUNGS.clear()
        _drop_rung_partition_keys(dead)
        for rdb in rdbs:
            planner.invalidate_stats(rdb)
    else:
        _invalidation_hook(db)


def rung_database(db: Database, table: str, strata, den: int,
                  seed: int = DEFAULT_SEED) -> Database:
    """A sibling ``Database`` that adds the rung table next to the originals
    (and shares their device tensors, :func:`backend.derive_database`).

    The rung table is registered in ``backend.PARTITION_KEYS`` under the base
    table's partition key, so distributed execution shards the sample the
    same way it shards the fact table instead of replicating it.
    """
    strata = tuple(strata)
    key = (id(db), table, strata, int(den), int(seed))
    hit = _RUNGS.get(key)
    if hit is not None:
        ref, rdb = hit
        if ref() is db:
            return rdb
        _RUNGS.pop(key, None)
    # deferred: keep sampling importable early
    from repro_torch.core import backend as B

    name = rung_name(table, den)
    samp = sample_table(db.tables[table], strata, den, seed)
    rdb = B.derive_database(db, {name: samp})
    # only partitioned base tables register: an explicit name -> None entry
    # would make dryrun analytics classify the rung as replicated
    pkey = B.PARTITION_KEYS.get(table)
    if pkey is not None:
        B.PARTITION_KEYS.setdefault(name, pkey)
    _RUNGS[key] = (weakref.ref(db), rdb)
    return rdb
