"""Per-query sort budgets of the 22 local plans, the port's counterpart of
``tests/test_sort_tax.py::test_hlo_sort_count_budget``.

Each query runs through ``run_local`` on the CPU at ``tpch.generate(0.005,
seed=11)`` on each leg of ``sortcount.LEGS`` (sorted or hash joins, planner
inference on or off, pinned per query with ``with_inference``), under
``SortCounter``.  Each count is within its ``MAX_SORTS`` budget; each
leg's total equals the budgets' sum, so a budget set looser than the count
shows; and turning the planner on never adds a sort.  The card's counts
equal these (``tests/test_torch_gpu.py``).
"""
import functools

import pytest

from repro_torch.core import backend as B
from repro_torch.core.sortcount import LEGS, MAX_SORTS, SortCounter
from repro_torch.data import tpch
from repro_torch.queries import QUERIES

_LEG_IDS = [f"{join}-planner_{'on' if on else 'off'}" for join, on in LEGS]


@functools.lru_cache(maxsize=None)
def _db():
    return tpch.generate(0.005, seed=11)


@functools.lru_cache(maxsize=None)
def sorts(qid: int, join: str, planner: bool) -> int:
    with SortCounter() as c:
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
