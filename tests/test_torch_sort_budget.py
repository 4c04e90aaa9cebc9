"""Per-query sort budgets of the 22 local plans, the port's counterpart of
``tests/test_sort_tax.py::test_hlo_sort_count_budget``.

Each query runs through ``run_local`` on the CPU at ``tpch.generate(0.005,
seed=11)`` on each leg of ``sortcount.LEGS`` (sorted or hash joins, planner
inference on or off, pinned per query with ``with_inference``), under
``SortCounter``.  Each count is within its ``MAX_SORTS`` budget; each
leg's total equals the budgets' sum, so a budget set looser than the count
shows; and turning the planner on never adds a sort.  The card's counts
equal these (``tests/test_torch_gpu.py``).

The budgets at larger scales (``sortcount.MAX_SORTS_AT``): the sorts of a
plan depend on the methods the planner picks, not on the data, so scale sf
is counted on the sf 0.005 database under sf's key domains
(``dryrun_analytics.sf_stats``: a wider domain only sends a group-by to the
sort path, which is right for any data), and sf 0.01 seed 7 also on its own
generated data.  Each extra sort is derived by hand from the key widths.
"""
import contextlib
import functools

import pytest
import torch

from repro_torch.core import backend as B
from repro_torch.core import plan as P
from repro_torch.core import planner as PL
from repro_torch.core.sortcount import (LEGS, MAX_SORTS, MAX_SORTS_AT,
                                        SCALE_GROUP_BYS, SCALES, SortCounter,
                                        budgets)
from repro_torch.data import tpch
from repro_torch.launch.dryrun_analytics import sf_stats
from repro_torch.queries import QUERIES

_LEG_IDS = [f"{join}-planner_{'on' if on else 'off'}" for join, on in LEGS]


@functools.lru_cache(maxsize=None)
def _db():
    return tpch.generate(0.005, seed=11)


@contextlib.contextmanager
def one_thread():
    """Count on one CPU thread: the plans' small operations gain nothing
    from more, and on a host shared with other test workers a pool of
    threads per worker makes them several times slower.  Sort counts do
    not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def sorts(qid: int, join: str, planner: bool) -> int:
    with one_thread(), SortCounter() as c:
        B.run_local(QUERIES[qid].with_inference(planner), _db(),
                    join_method=join, device="cpu")
    return len(c.calls)


def test_every_query_has_a_budget_on_every_leg():
    assert sorted(MAX_SORTS) == sorted(QUERIES)
    assert all(len(b) == len(LEGS) for b in MAX_SORTS.values())


@pytest.mark.parametrize("leg", range(len(LEGS)), ids=_LEG_IDS)
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_sort_count_within_budget(qid, leg):
    got = sorts(qid, *LEGS[leg])
    assert got <= MAX_SORTS[qid][leg], \
        f"q{qid} {_LEG_IDS[leg]}: {got} sorts > budget {MAX_SORTS[qid][leg]}"


@pytest.mark.parametrize("join", ["sorted", "hash"])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_planner_on_sorts_no_more_than_off(qid, join):
    assert sorts(qid, join, True) <= sorts(qid, join, False)


@pytest.mark.parametrize("leg", range(len(LEGS)), ids=_LEG_IDS)
def test_budgets_sum_to_the_counts(leg):
    got = sum(sorts(q, *LEGS[leg]) for q in sorted(QUERIES))
    assert got == sum(b[leg] for b in MAX_SORTS.values())


# -- budgets at each scale ----------------------------------------------------

def _count_on_legs(qid: int, db) -> tuple[int, ...]:
    """Sorts on each planner-on leg, in LEGS order.  The planner-off legs
    read no statistics, so their counts are sf 0.005's at every scale
    (``test_sort_count_within_budget`` counts them)."""
    out = []
    for join, planner in LEGS:
        if planner:
            with one_thread(), SortCounter() as c:
                B.run_local(QUERIES[qid].with_inference(True), db,
                            join_method=join, device="cpu")
            out.append(len(c.calls))
    return tuple(out)


def _on_legs(budget: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(b for b, (_, planner) in zip(budget, LEGS) if planner)


@functools.lru_cache(maxsize=None)
def _counts_at(sf: float) -> dict[int, tuple[int, ...]]:
    """Every query's sorts on each planner-on leg under scale ``sf``'s key
    domains."""
    db = _db()
    with sf_stats(db, sf):
        return {q: _count_on_legs(q, db) for q in sorted(QUERIES)}


@functools.lru_cache(maxsize=None)
def _db_seed7():
    return tpch.generate(0.01, seed=7)


def test_budgets_cover_the_scales_run():
    assert sorted(MAX_SORTS_AT) == sorted(sf for sf, _ in SCALES)
    assert budgets(0.005) is MAX_SORTS       # sf 0.005's are unchanged
    with pytest.raises(ValueError):
        budgets(0.5)


@pytest.mark.parametrize("qid", sorted(QUERIES))
@pytest.mark.parametrize("sf", [0.005, 0.01, 1.0, 10.0])
def test_sorts_equal_the_budget_at_scale(sf, qid):
    assert _counts_at(sf)[qid] == _on_legs(budgets(sf)[qid])
    # the planner-off legs: the same at every scale
    assert [b for b, (_, on) in zip(budgets(sf)[qid], LEGS) if not on] == \
        [sorts(qid, join, False) for join, on in LEGS if not on]


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_sorts_on_generated_data_at_sf_001_seed_7(qid):
    assert _count_on_legs(qid, _db_seed7()) == _on_legs(budgets(0.01)[qid])


# the owning table of each scale key, and its rows per unit of scale factor
# (TPC-H: orders 1.5 M, customer 150 k, part 200 k, supplier 10 k)
_KEY_ROWS = {"l_orderkey": 1_500_000, "o_custkey": 150_000,
             "ps_partkey": 200_000, "l_partkey": 200_000,
             "l_suppkey": 10_000, "ps_suppkey": 10_000}


@pytest.mark.parametrize("sf", [0.005, 0.01, 1.0, 10.0])
def test_each_extra_sort_follows_from_the_key_widths(sf):
    """A single-key group-by on dense keys 1..rows takes the direct path
    while bit_length(rows) <= 13 bits, else (rows > 8191 > 4096, so not the
    hash path either) one sort on each planner-on leg."""
    for qid in sorted(QUERIES):
        wide = sum(int(_KEY_ROWS[k] * sf).bit_length() > 13
                   for k in SCALE_GROUP_BYS.get(qid, ()))
        want = tuple(b + wide if planner else b
                     for b, (_, planner) in zip(MAX_SORTS[qid], LEGS))
        assert budgets(sf)[qid] == want, f"q{qid} at sf {sf}"


def _methods(qid: int, db) -> list[tuple[tuple[str, ...], str]]:
    info = PL.analyze(QUERIES[qid].plan, db)
    out = []
    for n in PL.walk(QUERIES[qid].plan):
        if isinstance(n, P.GroupBy):
            kb, _ = info.hints_for(n)
            out.append((n.keys, "direct" if kb else
                        info.method_for(n) or "sort"))
    return out


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_scale_group_bys_are_the_ones_that_leave_the_direct_path(qid):
    db = _db()
    small = _methods(qid, db)
    with sf_stats(db, 1.0):
        large = _methods(qid, db)
    moved = sorted(k for (k, a), (_, b) in zip(small, large)
                   if (a, b) == ("direct", "sort"))
    assert moved == sorted((k,) for k in SCALE_GROUP_BYS.get(qid, ()))
    # no other group-by changes its path between the scales
    assert [m for m in zip(small, large) if m[0][1] != m[1][1]] == \
        [m for m in zip(small, large) if (m[0][1], m[1][1]) ==
         ("direct", "sort")]
