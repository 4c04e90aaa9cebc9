"""The slice as a whole: all 22 TPC-H queries on the port's single-device
engine (``repro_torch.core.backend.run_local``, plain PyTorch versions on the
CPU) against the reference package.

The reference database reaches the port through ``table.database_from``, so
both engines run on the same arrays.  Results follow the rule of
``tests/test_queries.py``: row counts equal, floats to rtol 1e-7.  Plan
statistics (paper Table 4 exchange counts) and the per-exchange wire log must
be identical to the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.data import tpch as rtpch
from repro.queries import PAPER_TABLE4
from repro.queries import QUERIES as RQ

from repro_torch.core import backend as B
from repro_torch.core import table as T
from repro_torch.data import tpch
from repro_torch.queries import QUERIES


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(0.005, seed=11)
    return rdb, T.database_from(rdb)


def _compare(got, want, label):
    keys = set(got) & set(want)
    assert keys, f"{label}: no common output columns"
    n = len(next(iter(want.values())))
    for k in sorted(keys):
        assert len(got[k]) == n, f"{label} {k}: row count"
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   rtol=1e-7, err_msg=f"{label} {k}")


def _wire(stats):
    return [(e.kind, e.wire, e.row_wire_bytes, e.row_logical_bytes)
            for e in stats.log]


def test_generate_is_identical():
    rdb, pdb = rtpch.generate(0.01, seed=3), tpch.generate(0.01, seed=3)
    assert rdb.scale == pdb.scale and set(rdb.tables) == set(pdb.tables)
    for name, cols in rdb.tables.items():
        assert set(cols) == set(pdb.tables[name])
        for c, v in cols.items():
            got = pdb.tables[name][c]
            assert got.dtype == v.dtype, (name, c)
            np.testing.assert_array_equal(got, v, err_msg=f"{name}.{c}")
    for c, v in rdb.dicts.items():
        np.testing.assert_array_equal(pdb.dicts[c], v)


@pytest.mark.parametrize("join_method", ["sorted", "hash"])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_query_matches_reference(dbs, qid, join_method):
    rdb, pdb = dbs
    want, wstats = RB.run_reference(RQ[qid], rdb)
    got, stats = B.run_local(QUERIES[qid], pdb, join_method=join_method,
                             device="cpu")
    _compare(got, want, f"q{qid} join={join_method}")
    assert stats.counts() == wstats.counts()
    assert _wire(stats) == _wire(wstats)
    want_s, want_b = PAPER_TABLE4[qid]
    if qid == 11:           # the reference's documented deviation
        assert (stats.shuffles, stats.broadcasts) == (0, 1)
    else:
        assert stats.shuffles == want_s
        assert want_b is None or stats.broadcasts == want_b


@pytest.mark.parametrize("qid", [1, 13, 15, 18])
def test_query_matches_reference_engine(dbs, qid):
    """Against the reference's own single-device engine: the direct (Q1),
    hash (Q13), scalar (Q15) and sort (Q18) aggregation paths."""
    rdb, pdb = dbs
    want, wstats = RB.run_local(RQ[qid], rdb)
    got, stats = B.run_local(QUERIES[qid], pdb, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    _compare(got, want, f"q{qid}")
    assert _wire(stats) == _wire(wstats)
    assert _wire(stats) == [(d["kind"], d["wire"], d["row_wire_bytes"],
                             d["row_logical_bytes"])
                            for d in QUERIES[qid].static_wire(pdb)]


def test_plans_and_hints_match_reference(dbs):
    rdb, pdb = dbs
    for qid in sorted(QUERIES):
        assert QUERIES[qid].static_counts() == RQ[qid].static_counts()
        assert QUERIES[qid].explain(pdb) == RQ[qid].explain(rdb)
        assert QUERIES[qid].signature() == RQ[qid].signature()


@pytest.mark.parametrize("qid", [1, 22])
def test_averages_are_float64(dbs, qid):
    """torch would give float32 for int64 / int64 and int * float; the port
    lifts those to float64 as JAX under x64 does."""
    rdb, pdb = dbs
    want, _ = RB.run_reference(RQ[qid], rdb)
    got, _ = B.run_local(QUERIES[qid], pdb, device="cpu")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    if qid == 1:
        assert all(got[k].dtype == np.float64 for k in got if "avg" in k)
    ctx = B.LocalContext(pdb, B.device_tables(pdb, torch.device("cpu")),
                         torch.device("cpu"))
    t = ctx.scan("lineitem")
    out = ctx.agg_scalar(t, [("a", "avg", "l_quantity")])
    assert out["a"].dtype == torch.float64


def test_device_defaults_to_cuda_and_never_falls_back(dbs, monkeypatch):
    _, pdb = dbs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.run_local(QUERIES[6], pdb)
    # the sample-ladder rewrite is host-side; running it wants the card too
    rw = QUERIES[6].approximate(pdb, 4)
    assert rw is not None and rw.den == 4
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.run_local(rw.query, rw.db)
