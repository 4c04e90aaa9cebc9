"""The 22 TPC-H queries as lazy logical plans (paper §4.4, now compiled).

Each query module function (``q1()`` .. ``q22()``) BUILDS a logical plan —
a plain-data DAG of ``repro_torch.core.plan`` nodes with column-expression trees —
and ``repro_torch.core.planner`` compiles it against the physical ``Context`` API.
``QUERIES[qid]`` is the compiled form: a callable ``query_fn(ctx)`` exactly
like the legacy eager plans, runnable unchanged on ``RefContext`` /
``LocalContext`` / ``DistContext``.  Exchange placement (``.shuffle()`` /
``.broadcast()`` / ``exchange=`` on group_by) remains explicit plan
structure, following the paper's plans under its §4.3 input partitioning:

  lineitem@l_orderkey  orders@o_orderkey  partsupp@ps_partkey  part@p_partkey
  supplier@s_suppkey   customer@c_custkey nation,region replicated

Exchange counts per plan are derived statically from the IR and asserted
against paper Table 4 in tests/test_plan_stats.py — alongside the runtime
counts, which they must equal on every backend (Q11 deviates from the paper:
our partitioning makes the group-by local where the paper shuffles).

Planner contract (replaces the hand hint-threading convention)
--------------------------------------------------------------
The physical engine still takes two static hints on ``group_by`` —
``key_bits`` (provable per-column key widths; sum <= 13 unlocks the sortless
direct-addressing aggregation) and ``groups_hint`` (distinct-group bound that
shrinks partials before an exchange).  Plans NO LONGER state them:

  * ``key_bits`` is ALWAYS inferred — by bound propagation from per-column
    min/max statistics (dictionary domains, generated key ranges) through
    filters and expression arithmetic.  Query code contains zero hand-written
    key widths, and inference runs against the database that executes, so an
    inferred width cannot lie in normal execution.  Stand-in compiles whose
    tables are NOT the analyzed database (the SF=1000 dry-run) must inject
    matching statistics (``launch/dryrun_analytics._sf1000_stats``) or
    compile with inference off.
  * ``groups_hint`` is inferred from key-domain cardinality products where
    provable; a plan may still pass ``groups_hint=`` for bounds the planner
    cannot prove (data-dependent group counts — Q13's orders-per-customer
    histogram is the one remaining case).  When both exist the tighter bound
    wins.  An author claim that undercounts raises ``ctx.overflow``; capacity
    escalation alone cannot fix that, so the fault runner recompiles with
    inference off after a failed escalation (``distributed/fault.py``) —
    groups are never silently dropped either way.
  * The aggregation method follows from the hints per database: direct
    addressing where the key domain proves small, the hash-compaction
    dictionary (``kernels/hash_group``) where only a ``groups_hint`` exists
    (the Q13 shape — zero sorts with no width claim at all), and the
    single-sort path otherwise.  The same plan degrades gracefully across
    scale factors.
  * **Wire widths are inferred too**: every exchange (broadcast / shuffle /
    exchanged group-by / final gather) ships its payload at the lane widths
    the same column statistics prove (``core/wire.py``), with a per-column
    runtime range check feeding ``ctx.overflow``.  Plans carry no wire
    fields; ``REPRO_WIRE=wide`` forces the legacy full-width format (the
    differential leg) and unhinted compilation is wide by construction.

``REPRO_PLANNER=0`` disables all hints (the conservative leg CI runs to pin
that hinted and unhinted compilation agree — byte-identical per aggregation
engine, rtol=1e-9 across engines on the forced-kernel leg; see
tests/test_planner.py); ``QUERIES[qid].with_inference(True/False)`` pins the
mode per call site.

Deferred compaction: intermediate tables a plan sees after filters and joins
may be *masked* (valid-row mask, not front-compacted) — plans must not index
rows positionally; row-positional operators (``finalize``, ``shrink``,
broadcasts) compact internally.  Column expressions run on garbage rows too,
which is safe because garbage values are always drawn from previously valid
rows and therefore stay in-domain for every LUT.
"""
import os

from repro_torch.core.planner import compile_query

from . import q01_08, q09_15, q16_22

# plan builders: call to get a FRESH logical-plan root (benchmarks time this)
PLANS = {}
for _mod in (q01_08, q09_15, q16_22):
    for _name in _mod.__all__:
        PLANS[int(_name[1:])] = getattr(_mod, _name)

# REPRO_FRONTEND=sql selects plans compiled from the SQL texts in the
# reference package.  The port has no SQL frontend yet (ROADMAP queue A,
# item 8), so it refuses rather than quietly serving the hand-built plans.
if os.environ.get("REPRO_FRONTEND", "").lower() == "sql":
    raise NotImplementedError(
        "REPRO_FRONTEND=sql: repro_torch has no SQL frontend yet "
        "(ROADMAP A8); unset it to run the hand-built plans")

# compiled queries: `query_fn(ctx)` callables, plan built once and shared
QUERIES = {qid: compile_query(fn, name=f"q{qid}")
           for qid, fn in sorted(PLANS.items())}

# Paper Table 4 (legible cells) — (shuffles, broadcasts); final gathers and
# allreduces are excluded, as in the paper.
PAPER_TABLE4 = {
    1: (0, 0), 2: (0, 1), 3: (0, 1), 4: (0, 0), 5: (0, 2), 6: (0, 0),
    7: (0, 2), 8: (0, 3), 9: (1, 2), 10: (1, 0), 11: (1, 1), 12: (0, 0),
    13: (1, None), 14: (1, None), 15: (1, None), 16: (1, None),
    17: (1, None), 18: (0, None), 19: (0, None), 20: (1, None),
    21: (0, None), 22: (1, None),
}

__all__ = ["QUERIES", "PLANS", "PAPER_TABLE4"]
