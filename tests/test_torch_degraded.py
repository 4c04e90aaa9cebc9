"""Degraded-group execution in the port: the device-loss taxonomy, the
topology-shrink rung of ``QueryRunner`` over a ``ThreadGroup``, snapshot
re-sharding, jittered backoff and overall deadlines — the cases of the
reference's tests/test_degraded.py that have a counterpart (its serving
cases wait for ``serve/``).  The 22-query shrink sweeps are in
tests/test_torch_device_loss_sweep.py."""
import os

import numpy as np
import pytest

from repro.distributed import chaos as rchaos
from repro.distributed import fault as rfault
from repro.distributed import lineage as rln
from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.data import tpch
from repro_torch.distributed import lineage as ln
from repro_torch.distributed.chaos import (ChaosInjector, DeviceLost,
                                           FailureKind, FaultPlan, FaultSpec,
                                           chaos_env_lost, resolve_lost)
from repro_torch.distributed.fault import (QueryRunner, QueryTimeout,
                                           RetryPolicy, classify_failure,
                                           surviving_group)
from repro_torch.distributed.lineage import LineageStore, run_resumable
from repro_torch.queries import QUERIES


@pytest.fixture(scope="module")
def db():
    return tpch.generate(0.002, seed=11)


# ---------------------------------------------------------------------------
# taxonomy + fault plumbing
# ---------------------------------------------------------------------------

def test_device_lost_classification():
    assert classify_failure(DeviceLost("gone")) is FailureKind.DEVICE_LOST
    assert FailureKind.DEVICE_LOST.value == "device_lost"
    assert [k.value for k in FailureKind] == \
        [k.value for k in rchaos.FailureKind]


def test_fault_spec_device_lost_validation():
    FaultSpec("device_lost", devices=(0, 3))
    FaultSpec("device_lost", n_lost=2)
    with pytest.raises(ValueError):
        FaultSpec("device_lost", devices=(-1,))
    with pytest.raises(ValueError):
        FaultSpec("device_lost", n_lost=0)


def test_resolve_lost_deterministic_and_survivor_preserving():
    e = DeviceLost("x", n_lost=3, seed=42)
    a = resolve_lost(e, 8)
    assert a == resolve_lost(e, 8)
    assert len(a) == 3 and len(set(a)) == 3
    assert all(0 <= d < 8 for d in a)
    assert resolve_lost(DeviceLost("x", lost=(2, 11)), 8) == (2,)
    assert len(resolve_lost(DeviceLost("x", n_lost=64, seed=1), 8)) == 7
    assert resolve_lost(DeviceLost("x", n_lost=5, seed=1), 1) == ()


@pytest.mark.parametrize("world", [1, 2, 4, 7, 8])
def test_resolve_lost_equals_the_reference(world):
    for seed in range(30):
        for n_lost in (1, 2, 3, 9):
            got = resolve_lost(DeviceLost("x", n_lost=n_lost, seed=seed),
                               world)
            want = rchaos.resolve_lost(
                rchaos.DeviceLost("x", n_lost=n_lost, seed=seed), world)
            assert got == want, (seed, n_lost, world)
    ranks = (0, 3, 5, 12)
    assert resolve_lost(DeviceLost("x", lost=ranks), world) == \
        rchaos.resolve_lost(rchaos.DeviceLost("x", lost=ranks), world)


def test_chaos_env_lost_grammar(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "9,lose=3")
    assert chaos_env_lost() == ((3,), "exchange")
    monkeypatch.setenv("REPRO_CHAOS", "9,lose=1+4+6@scan")
    assert chaos_env_lost() == ((1, 4, 6), "scan")
    monkeypatch.setenv("REPRO_CHAOS", "9")
    assert chaos_env_lost() is None
    monkeypatch.setenv("REPRO_CHAOS", "9,drop=3")
    with pytest.raises(ValueError):
        chaos_env_lost()
    monkeypatch.setenv("REPRO_CHAOS", "9,lose=3@scan")
    inj = ChaosInjector.from_env()
    assert inj.plan.faults[0].kind == "device_lost"
    assert inj.plan.faults[0].devices == (3,)
    assert inj.plan.faults[0].cut == "scan"


def test_surviving_group():
    g = comm.ThreadGroup(8, "cpu")
    s = surviving_group(g, (1, 6))
    assert isinstance(s, comm.ThreadGroup)
    assert s.size == 6 and s.device == g.device
    with pytest.raises(ValueError, match="no survivors"):
        surviving_group(comm.ThreadGroup(1, "cpu"), (0,))


# ---------------------------------------------------------------------------
# seeded decorrelated jitter and the overall deadline
# ---------------------------------------------------------------------------

def test_backoff_without_jitter_is_exact_exponential():
    p = RetryPolicy(backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.5)
    assert [p.backoff(i) for i in (1, 2, 3, 4)] == [0.1, 0.2, 0.4, 0.5]


def test_backoff_jitter_deterministic_bounded_decorrelated():
    p = RetryPolicy(backoff_s=0.05, max_backoff_s=2.0, jitter=True, seed=7)
    seq = [p.backoff(i) for i in (1, 2, 3, 4, 5)]
    assert seq == [p.backoff(i) for i in (1, 2, 3, 4, 5)]
    assert all(p.backoff_s <= s <= p.max_backoff_s for s in seq)
    prev = p.backoff_s
    for s in seq:
        assert s <= min(p.max_backoff_s, max(p.backoff_s, 3.0 * prev)) + 1e-12
        prev = s
    q = RetryPolicy(backoff_s=0.05, max_backoff_s=2.0, jitter=True, seed=8)
    assert seq != [q.backoff(i) for i in (1, 2, 3, 4, 5)]
    assert RetryPolicy(backoff_s=0.05, jitter=True).backoff(2) == 0.1
    # the jitter is the reference's, draw for draw
    r = rfault.RetryPolicy(backoff_s=0.05, max_backoff_s=2.0, jitter=True,
                           seed=7)
    assert seq == [r.backoff(i) for i in (1, 2, 3, 4, 5)]


def test_query_timeout_carries_partial_report(db):
    inj = ChaosInjector(FaultPlan(3, tuple(
        FaultSpec("transient", cut="scan", attempt=a) for a in (1, 2, 3))))
    runner = QueryRunner(db, 1, chaos=inj, deadline_s=0.0, device="cpu",
                         policy=RetryPolicy(max_attempts=4, backoff_s=0.0))
    with pytest.raises(QueryTimeout) as ei:
        runner.run(QUERIES[1])
    assert ei.value.report.outcomes() == ["transient"]
    assert "deadline" in str(ei.value)


def test_no_deadline_keeps_full_attempt_budget(db):
    inj = ChaosInjector(FaultPlan(3, (
        FaultSpec("transient", cut="scan", attempt=1),)))
    runner = QueryRunner(db, 1, chaos=inj, device="cpu",
                         policy=RetryPolicy(max_attempts=3, backoff_s=0.0))
    assert runner.run(QUERIES[1]).report.outcomes() == ["transient", "ok"]


# ---------------------------------------------------------------------------
# re-shard: stacked-layout round trips
# ---------------------------------------------------------------------------

def _stacked(rng, nrows, n, key_range=1000):
    one = {"k": rng.integers(0, key_range, nrows).astype(np.int64),
           "v": rng.standard_normal(nrows),
           "f": rng.integers(0, 2, nrows).astype(bool),
           "__count": np.array([nrows], np.int32)}
    return ln.reshard(one, 1, n, "k")


@pytest.mark.parametrize("n_from,n_to", [(n, m) for n in range(1, 9)
                                         for m in range(1, 9) if n != m])
def test_reshard_round_trips_all_width_pairs(n_from, n_to):
    """N -> N' -> N is byte-identical for every pair up to 8, empty
    partitions included, and each step equals the reference's."""
    rng = np.random.default_rng(n_from * 10 + n_to)
    for nrows in (0, 3, 57):
        a = _stacked(rng, nrows, n_from)
        b = ln.reshard(a, n_from, n_to, "k")
        c = ln.reshard(b, n_to, n_from, "k")
        assert set(a) == set(c)
        for k in a:
            assert a[k].dtype == c[k].dtype, k
            assert np.array_equal(a[k], c[k]), (k, nrows)
        assert b["__count"].sum() == a["__count"].sum() == nrows
        want = rln.reshard(a, n_from, n_to, "k")
        assert set(b) == set(want)
        for k in b:
            assert b[k].dtype == want[k].dtype
            assert np.array_equal(b[k], want[k]), k


def test_reshard_rowid_restores_global_order():
    rng = np.random.default_rng(0)
    nrows = 41
    one = {"k": rng.integers(0, 100, nrows).astype(np.int64),
           "v": rng.standard_normal(nrows),
           "__count": np.array([nrows], np.int32)}
    g = ln.unshard(ln.reshard(one, 1, 7, "k"), 7)
    assert np.array_equal(g["__rowid"], np.arange(nrows))
    assert np.array_equal(g["k"], one["k"])
    assert np.array_equal(g["v"], one["v"])


def test_reshard_replicated_and_errors():
    rng = np.random.default_rng(1)
    one = {"k": rng.integers(0, 9, 10).astype(np.int64),
           "__count": np.array([10], np.int32)}
    rep = ln.reshard(one, 1, 4, None)
    assert np.array_equal(rep["__count"], np.full(4, 10, np.int32))
    with pytest.raises(ValueError):
        ln.reshard(one, 1, 0, "k")
    with pytest.raises(ValueError):
        ln.unshard({"k": np.zeros(8, np.int64),
                    "__count": np.array([9], np.int32)}, 1)


# ---------------------------------------------------------------------------
# lineage: width-elastic snapshot adoption
# ---------------------------------------------------------------------------

def _populate(db, store, qid, n_devices):
    inj = ChaosInjector(FaultPlan(qid, (
        FaultSpec("transient", cut="finalize", attempt=1),)))
    with pytest.raises(Exception):
        run_resumable(QUERIES[qid], db, store, chaos=inj,
                      n_devices=n_devices, device="cpu")
    assert store.saved >= 1


def test_lineage_resume_across_widths_byte_identical(db, tmp_path):
    store = LineageStore(str(tmp_path / "lin"))
    _populate(db, store, 5, n_devices=8)
    res, _, _, reused = run_resumable(QUERIES[5], db, store, n_devices=5,
                                      device="cpu")
    assert reused >= 1 and store.resharded >= 1
    clean = B.run_local(QUERIES[5], db, device="cpu")[0]
    assert set(res) == set(clean)
    for k in res:
        assert res[k].dtype == clean[k].dtype
        assert np.array_equal(res[k], clean[k]), k


def test_lineage_same_width_resume_does_not_count_reshard(db, tmp_path):
    store = LineageStore(str(tmp_path / "lin"))
    _populate(db, store, 5, n_devices=8)
    _, _, _, reused = run_resumable(QUERIES[5], db, store, n_devices=8,
                                    device="cpu")
    assert reused >= 1 and store.resharded == 0


def test_lineage_rejects_non_width_mismatch(db, tmp_path):
    store = LineageStore(str(tmp_path / "lin"))
    _populate(db, store, 5, n_devices=8)
    _, _, _, reused = run_resumable(QUERIES[5], db, store, n_devices=5,
                                    wire_format="wide", device="cpu")
    assert reused == 0 and store.resharded == 0


def test_lineage_torn_snapshot_falls_back_to_reexecution(db, tmp_path):
    store = LineageStore(str(tmp_path / "lin"))
    _populate(db, store, 5, n_devices=8)
    for step in os.listdir(store.dir):
        d = os.path.join(store.dir, step)
        for f in os.listdir(d):
            if f.endswith(".npy"):
                with open(os.path.join(d, f), "r+b") as fh:
                    fh.seek(-1, os.SEEK_END)
                    last = fh.read(1)
                    fh.seek(-1, os.SEEK_END)
                    fh.write(bytes([last[0] ^ 0xFF]))
    res, _, _, reused = run_resumable(QUERIES[5], db, store, n_devices=5,
                                      device="cpu")
    assert reused == 0
    clean = B.run_local(QUERIES[5], db, device="cpu")[0]
    for k in res:
        assert np.array_equal(res[k], clean[k]), k


def test_plan_fingerprint_equals_the_reference():
    """The content fingerprint over the port's plan walk is the
    reference's, bindings included (a snapshot store is portable)."""
    from repro.core import planner as rpl
    from repro.queries import QUERIES as RQ
    from repro_torch.core import planner as pl
    for qid in (1, 5, 9, 13, 18):
        nodes, rnodes = pl.walk(QUERIES[qid].plan), rpl.walk(RQ[qid].plan)
        assert ln.plan_fingerprint(nodes) == rln.plan_fingerprint(rnodes)
        assert ln.plan_fingerprint(nodes, {"p": 3, "q": 1.5}) == \
            rln.plan_fingerprint(rnodes, {"p": np.int64(3),
                                          "q": np.float64(1.5)})


# ---------------------------------------------------------------------------
# runner: the topology-shrink rung
# ---------------------------------------------------------------------------

def test_runner_device_lost_on_1_rank_raises(db):
    inj = ChaosInjector(FaultPlan.device_loss(3, n_lost=1, cut="scan"))
    runner = QueryRunner(db, 1, chaos=inj, device="cpu")
    with pytest.raises(DeviceLost):
        runner.run(QUERIES[1])
    assert runner.topology_generation == 0


def test_runner_attempt_reports_carry_width_and_generation(db):
    res = QueryRunner(db, 1, device="cpu").run(QUERIES[1])
    (a,) = res.report.attempts
    assert a.devices == 1 and a.generation == 0


def test_shrink_frees_the_old_width_and_reprices(db):
    """4 -> 3: the runner re-partitions over the survivors, drops the
    4-rank shards from the device cache, and pins the cluster spec's
    live width."""
    from repro_torch.core.perfmodel import CLUSTERS
    runner = QueryRunner(db, 4, device="cpu", cluster=CLUSTERS["h100_ib"],
                         chaos=ChaosInjector(FaultPlan.device_loss(
                             5, devices=(2,), cut="exchange")))
    res = runner.run(QUERIES[9])
    assert res.report.outcomes() == ["device_lost", "ok"]
    assert (runner.devices, runner.topology_generation,
            runner.lost_devices) == (3, 1, (2,))
    assert runner.cluster.n_devices == 3
    widths = {key[1] for key in db.__dict__[B._DEVICE_SHARDS]}
    assert 4 not in widths and 3 in widths
    clean, _, _ = B.run_distributed(QUERIES[9], db, 3, device="cpu")
    for k in clean:
        assert np.array_equal(clean[k], res.result[k]), k


@pytest.mark.parametrize("plan", [
    FaultPlan.device_loss(5, devices=(2,), cut="exchange"),
    FaultPlan.device_loss(5, n_lost=1, cut="group_by")])
def test_shrink_frees_the_dead_width_without_a_collection(plan):
    """The 4-rank shards die with the shrink itself: a rank's error, whose
    traceback holds the rank's frames and tables, is in no reference cycle
    (a cycle would keep them until a garbage collection, two widths of
    shards on the card)."""
    import gc
    import weakref
    import torch
    db = tpch.generate(0.002, seed=11)
    gc.collect()
    gc.disable()
    try:
        shards = B.device_shards(db, torch.device("cpu"), 4)
        refs = [weakref.ref(c) for rank in shards.values()
                for t in rank.values() for c in t.columns.values()]
        del shards
        res = QueryRunner(db, 4, device="cpu",
                          chaos=ChaosInjector(plan)).run(QUERIES[9])
        assert res.report.outcomes() == ["device_lost", "ok"]
        assert not [r for r in refs if r() is not None]
    finally:
        gc.enable()
