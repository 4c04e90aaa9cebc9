"""Sort-count gate: the port's sortless paths take no sort.

The reference counts HLO ``sort`` ops; the port counts the ``aten`` calls
that sort (``sort``, ``argsort``, ``unique`` in its forms, ``topk``) with
``repro_torch.core.sortcount.SortCounter``.  The shuffle dispatch (the
counting rank) and the direct and hash group-bys must take none; the
per-query budgets are ``tests/test_torch_sort_budget.py``'s.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import comm
from repro_torch.core import exchange as ex
from repro_torch.core import relational as rel
from repro_torch.core.sortcount import SortCounter
from repro_torch.core.table import from_numpy


def _table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 1000, n).astype(np.int64),
            "g": rng.integers(0, 50, n).astype(np.int32),
            "v": rng.normal(size=n)}
    t = from_numpy(cols, capacity=n + 64, device="cpu")
    return rel.filter_rows(t, t["k"] < 900)


def test_counter_sees_sorts():
    t = _table()
    with SortCounter() as c:
        torch.argsort(t["k"], stable=True)
        rel.group_aggregate(t, ["k"], [("s", "sum", "v")], method="sort")
    assert len(c.calls) >= 2


def test_shuffle_dispatch_takes_no_sort():
    dest = torch.from_numpy(
        np.random.default_rng(1).integers(0, 5, 10_000).astype(np.int32))
    with SortCounter() as c:
        ex._dispatch_offsets(dest, 4)
    assert c.calls == []


def test_shuffle_takes_no_sort():
    """A whole packed shuffle on each of 4 ranks: dispatch, pack, exchange,
    checksum, unpack — no sort anywhere."""
    def body(g):
        t = _table(seed=g.rank)
        with SortCounter() as c:
            ex.shuffle(t, t["k"], g, 2000, wire={"k": (0, 999),
                                                 "g": (0, 49)},
                       narrow=True)
            in_shuffle = list(c.calls)
            torch.sort(t["k"])       # the counter is live on this thread
        return in_shuffle, len(c.calls)

    assert comm.ThreadGroup(4, "cpu").run(body) == [([], 1)] * 4


@pytest.mark.parametrize("method,kw", [
    ("direct", dict(key_bits=[6])),
    ("hash", dict(groups_hint=64)),
])
def test_sortless_group_bys_take_no_sort(method, kw):
    t = _table()
    with SortCounter() as c:
        out = rel.group_aggregate(
            t, ["g"], [("s", "sum", "v"), ("n", "count", None),
                       ("m", "max", "k")], method=method, **kw)
    assert c.calls == []
    want = rel.group_aggregate(t, ["g"], [("s", "sum", "v")], method="sort")
    assert int(out.count) == int(want.count)
