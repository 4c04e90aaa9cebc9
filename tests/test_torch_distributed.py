"""The slice as a whole: all 22 TPC-H queries through the port's distributed
engine (``repro_torch.core.backend.run_distributed`` on a ThreadGroup of 4
ranks on the CPU, plain PyTorch versions of the kernels) against the
reference package.

Results follow the rule of ``tests/test_queries.py``: row counts exact,
floats to rtol 1e-7.  Runtime exchange counts must equal the reference's
static counts, and every exchange's wire row the reference's static wire
report.  Host partitioning (``partition_database``) must give the
reference's shards, on TPC-H and on the skewed JCC-H variant.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as RB
from repro.data import jcch as rjcch
from repro.data import tpch as rtpch
from repro.kernels.radix_hist import ops as RRH
from repro.queries import QUERIES as RQ

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core import table as T
from repro_torch.data import jcch
from repro_torch.kernels.radix_hist import ops as RH
from repro_torch.queries import QUERIES

EXCHANGE_HEAVY = [9, 10, 13, 18]


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(0.005, seed=11)
    return rdb, T.database_from(rdb)


@pytest.fixture(scope="module")
def refs(dbs):
    rdb, _ = dbs
    return {q: RB.run_reference(RQ[q], rdb)[0] for q in sorted(RQ)}


def _compare(got, want, label):
    keys = set(got) & set(want)
    assert keys, f"{label}: no common output columns"
    n = len(next(iter(want.values())))
    for k in sorted(keys):
        assert len(got[k]) == n, f"{label} {k}: row count"
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   rtol=1e-7, err_msg=f"{label} {k}")


def _run(pdb, qid, n=4, **kw):
    got, stats, overflow = B.run_distributed(
        QUERIES[qid], pdb, n, device="cpu", capacity_factor=3.0, **kw)
    assert not overflow, f"q{qid} overflow"
    return got, stats


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_distributed_matches_reference(dbs, refs, qid):
    rdb, pdb = dbs
    got, stats = _run(pdb, qid)
    _compare(got, refs[qid], f"q{qid}")
    assert stats.counts() == RQ[qid].static_counts()
    assert [(e.kind, e.row_wire_bytes, e.row_logical_bytes, e.wire)
            for e in stats.log] == \
        [(d["kind"], d["row_wire_bytes"], d["row_logical_bytes"], d["wire"])
         for d in RQ[qid].static_wire(rdb)]
    assert all(e.participants == 4 for e in stats.log)


@pytest.mark.parametrize("qid", EXCHANGE_HEAVY)
def test_distributed_eight_ranks_and_hash_joins(dbs, refs, qid):
    _, pdb = dbs
    for kw in (dict(n=8), dict(join_method="hash")):
        got, stats = _run(pdb, qid, **kw)
        _compare(got, refs[qid], f"q{qid} {kw}")
        assert stats.counts() == RQ[qid].static_counts()


@pytest.mark.parametrize("qid", EXCHANGE_HEAVY)
def test_narrow_equals_wide_byte_for_byte(dbs, qid):
    _, pdb = dbs
    narrow, ns = _run(pdb, qid, wire_format="narrow")
    wide, ws = _run(pdb, qid, wire_format="wide")
    assert set(narrow) == set(wide)
    for k in narrow:
        assert narrow[k].tobytes() == wide[k].tobytes(), k
    assert {e.wire for e in ws.log} == {"wide"}
    assert sum(e.row_wire_bytes for e in ns.log) <= \
        sum(e.row_wire_bytes for e in ws.log)


def test_per_column_exchange_matches_reference(dbs, refs):
    """The §2.3 baseline (one collective per column + the metadata round)."""
    _, pdb = dbs
    for qid in (3, 13):
        got, stats = _run(pdb, qid, packed_exchange=False)
        _compare(got, refs[qid], f"q{qid} per-column")
        assert all(e.wire == "wide" for e in stats.log)


@pytest.mark.parametrize("n", [4, 8])
def test_partition_database_equals_reference(dbs, n):
    rdb, pdb = dbs
    got, gcaps = B.partition_database(pdb, n)
    want, wcaps = RB.partition_database(rdb, n)
    assert gcaps == wcaps
    for name, cols in want.items():
        assert set(got[name]) == set(cols)
        for c, v in cols.items():
            np.testing.assert_array_equal(got[name][c], v,
                                          err_msg=f"{name}.{c}")


def test_hash_partition_np_matches_relational():
    from repro_torch.core import relational as rel
    keys = np.random.default_rng(0).integers(-2**62, 2**62, 5000)
    for n in (3, 4, 8):
        np.testing.assert_array_equal(
            B.hash_partition_np(keys, n),
            rel.hash_partition_ids(torch.from_numpy(keys), n).numpy())


def test_run_distributed_defaults_to_cuda(dbs, monkeypatch):
    _, pdb = dbs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.run_distributed(QUERIES[6], pdb, 4)


def test_thread_group_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        comm.ThreadGroup(2)
    assert comm.ThreadGroup(2, "cpu").device == torch.device("cpu")


def test_shards_are_cached_and_invalidated(dbs):
    from repro_torch.core import planner
    _, pdb = dbs
    cpu = torch.device("cpu")
    a = B.device_shards(pdb, cpu, 4)
    assert sorted(a) == [0, 1, 2, 3]
    assert B.device_shards(pdb, cpu, 4) is a
    assert B.device_shards(pdb, cpu, 2) is not a
    # a process that holds one rank uploads only that rank's shard
    planner.invalidate_stats(pdb)
    one = B.device_shards(pdb, cpu, 4, ranks=(2,))
    assert sorted(one) == [2]
    want, caps = B.partition_database(pdb, 4)
    li = one[2]["lineitem"]
    assert li.capacity == caps["lineitem"]
    assert int(li.count) == int(want["lineitem"]["__count"][2])
    np.testing.assert_array_equal(
        li["l_orderkey"].numpy(),
        want["lineitem"]["l_orderkey"][2 * li.capacity:3 * li.capacity])


# ---------------------------------------------------------------------------
# JCC-H, the skewed variant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jdbs():
    return rjcch.generate(0.005, seed=7), jcch.generate(0.005, seed=7)


def test_jcch_columns_equal_reference(jdbs):
    rdb, pdb = jdbs
    assert rdb.scale == pdb.scale and set(rdb.tables) == set(pdb.tables)
    for name, cols in rdb.tables.items():
        for c, v in cols.items():
            got = pdb.tables[name][c]
            assert got.dtype == v.dtype, (name, c)
            np.testing.assert_array_equal(got, v, err_msg=f"{name}.{c}")


def test_jcch_partition_counts_equal_reference(jdbs):
    rdb, pdb = jdbs
    got, gcaps = B.partition_database(pdb, 4)
    want, wcaps = RB.partition_database(rdb, 4)
    assert gcaps == wcaps
    for name in want:
        np.testing.assert_array_equal(got[name]["__count"],
                                      want[name]["__count"])


def test_jcch_skew_stats_equal_reference(jdbs):
    rdb, pdb = jdbs
    keys = pdb.tables["lineitem"]["l_partkey"].astype(np.int32)
    got = RH.skew_stats(torch.from_numpy(keys), 8)
    want = RRH.skew_stats(jnp.asarray(keys), 8, use_kernel=False)
    np.testing.assert_array_equal(got["per_partition"].numpy(),
                                  np.asarray(want["per_partition"]))
    assert float(got["imbalance"]) == float(want["imbalance"])
    # the hot keys really skew the partitions
    assert float(got["imbalance"]) > 1.1
