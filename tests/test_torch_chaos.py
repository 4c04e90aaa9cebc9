"""The port's chaos harness (``repro_torch.distributed.chaos``), failure
taxonomy and policy-driven ``QueryRunner`` (``distributed.fault``), and
lineage snapshots (``distributed.lineage``), on the cases of the reference's
tests/test_chaos.py that have a counterpart.

The port runs every rank of a group as its own call, so each rank reaches
every cut point: the injector counts visits per rank, fires a due fault on
every rank at the same visit and records it once.  The differential test at
the end holds that to the reference: the same ``FaultPlan`` on the
reference's runner over a 4-device mesh (a subprocess with virtual devices)
and on the port's over ``ThreadGroup(4, "cpu")`` must give equal events,
outcomes and results (the plans and the reference's script are in
``tests/torch_chaos_cases.py``, which ``test_torch_dist_procs.py`` shares).
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_chaos_cases as cases
from repro.distributed import chaos as rchaos
from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core import wire as W
from repro_torch.data import tpch
from repro_torch.distributed import chaos
from repro_torch.distributed.chaos import (ChaosInjector, FailureKind,
                                           FaultPlan, FaultSpec,
                                           TransientFault, chaos_env_seed)
from repro_torch.distributed.fault import (QueryRunner, RetryPolicy,
                                           classify_failure)
from repro_torch.distributed.lineage import LineageStore, run_resumable
from repro_torch.queries import QUERIES
from torch_chaos_cases import DIFF_CASES


@pytest.fixture(scope="module")
def db():
    return tpch.generate(0.005, seed=11)


class Ctx:
    """The flags a cut point may set, outside any engine."""

    def __init__(self, rank=None):
        self.overflow = torch.zeros((), dtype=torch.bool)
        self.corrupt = torch.zeros((), dtype=torch.bool)
        if rank is not None:
            self.group = type("G", (), {"rank": rank})()


# ---------------------------------------------------------------------------
# injector scheduling
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("meteor")
    with pytest.raises(ValueError):
        FaultSpec("transient", cut="join")
    FaultSpec("transient", cut="any")


def test_chaos_env_parsing(monkeypatch):
    for off in ("", "0", "off", "OFF", "none", "false"):
        monkeypatch.setenv("REPRO_CHAOS", off)
        assert chaos_env_seed() is None
        assert ChaosInjector.from_env() is None
    monkeypatch.delenv("REPRO_CHAOS")
    assert chaos_env_seed() is None
    monkeypatch.setenv("REPRO_CHAOS", "42")
    assert chaos_env_seed() == 42
    assert ChaosInjector.from_env().plan == FaultPlan.default(42)


def test_injector_fires_at_scheduled_visit_only():
    inj = ChaosInjector(FaultPlan(1, (
        FaultSpec("transient", cut="exchange", index=2, attempt=3),)))
    for attempt in (1, 2):
        inj.begin_attempt(attempt)
        for _ in range(5):
            assert inj.fire("exchange", Ctx()) is None
    inj.begin_attempt(3)
    assert inj.fire("exchange", Ctx()) is None       # visit 0
    assert inj.fire("scan", Ctx()) is None           # other cut: no advance
    assert inj.fire("exchange", Ctx()) is None       # visit 1
    with pytest.raises(TransientFault):
        inj.fire("exchange", Ctx())                  # visit 2: fires
    assert [e.attempt for e in inj.events] == [3]


def test_injector_any_cut_matches_first_visit():
    inj = ChaosInjector(FaultPlan(1, (
        FaultSpec("overflow", cut="any", index=0, attempt=1),)))
    ctx = Ctx()
    inj.fire("finalize", ctx)
    assert bool(ctx.overflow)
    assert inj.events[0].kind == "overflow"


def test_injector_counts_visits_per_rank():
    """Four ranks reach the cuts interleaved: each fires the due fault at
    its own second exchange, and the event is recorded once."""
    inj = ChaosInjector(FaultPlan(1, (
        FaultSpec("overflow", cut="exchange", index=1),
        FaultSpec("corrupt", cut="scan", index=0),)))
    ctxs = [Ctx(rank=r) for r in range(4)]
    for c in ctxs:
        inj.fire("exchange", c)
    assert not any(bool(c.overflow) for c in ctxs)
    for c in reversed(ctxs):
        inj.fire("scan", c)
        inj.fire("exchange", c)
    assert all(bool(c.overflow) and bool(c.corrupt) for c in ctxs)
    assert [(e.cut, e.index, e.kind, e.simulated) for e in inj.events] == \
        [("scan", 0, "corrupt", True), ("exchange", 1, "overflow", False)]


def test_injector_ranks_on_threads():
    """Ranks as threads (as in a ThreadGroup) racing through 200 cut
    visits each: every rank fires exactly the scheduled visit."""
    inj = ChaosInjector(FaultPlan(1, (
        FaultSpec("overflow", cut="group_by", index=137),)))
    ctxs = [Ctx(rank=r) for r in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(c):
            for i in range(200):
                inj.fire("group_by", c)
                if i == 136:
                    assert not bool(c.overflow)
        threads = [threading.Thread(target=body, args=(c,)) for c in ctxs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(bool(c.overflow) for c in ctxs)
    assert len(inj.events) == 1


def _tamper_pair(seed, cut, index, attempt):
    """The port's and the reference's tamper for one (seed, cut, visit,
    attempt)."""
    port = ChaosInjector(FaultPlan(seed, ()))
    ref = rchaos.ChaosInjector(rchaos.FaultPlan(seed, ()))
    port.begin_attempt(attempt)
    ref.begin_attempt(attempt)
    return port._tamper(cut, index), ref._tamper(cut, index)


@pytest.mark.parametrize("shape", [(8, 4), (3, 17, 5), (1, 1)])
def test_tamper_flips_the_reference_word_and_bit(shape):
    """The port's int32-view flip hits the same word and bit as the
    reference's uint32 bitcast, over seeds, cuts, visits and attempts (bit
    31 included: the int32 mask -2**31)."""
    rng = np.random.default_rng(5)
    buf = rng.integers(-2**31, 2**31, shape, dtype=np.int64) \
        .astype(np.int32)
    bits = set()
    for seed in range(40):
        for cut, index, attempt in (("exchange", 0, 1), ("group_by", 3, 2),
                                    ("finalize", 1, 4)):
            tp, tr = _tamper_pair(seed, cut, index, attempt)
            got = tp(torch.from_numpy(buf)).numpy()
            want = np.asarray(tr(jnp.asarray(buf)))
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            diff = (got ^ buf).view(np.uint32).reshape(-1)
            assert sum(bin(int(x)).count("1") for x in diff) == 1
            bits.add(int(np.log2(int(diff[diff != 0][0]))))
    assert 31 in bits and len(bits) > 20


def test_injector_deterministic_tamper_bit():
    a = ChaosInjector(FaultPlan(1, (FaultSpec("corrupt", cut="exchange"),)))
    b = ChaosInjector(FaultPlan(1, (FaultSpec("corrupt", cut="exchange"),)))
    c = ChaosInjector(FaultPlan(2, (FaultSpec("corrupt", cut="exchange"),)))
    buf = torch.zeros((8, 4), dtype=torch.int32)
    ta, tb, tc = (i.fire("exchange", Ctx(), tamperable=True)
                  for i in (a, b, c))
    assert torch.equal(ta(buf), tb(buf))
    assert not torch.equal(ta(buf), tc(buf))
    assert not bool(buf.any())                     # the input is untouched


# ---------------------------------------------------------------------------
# failure taxonomy + retry policy + the runner
# ---------------------------------------------------------------------------

def test_classification_table():
    assert classify_failure(W.CorruptPayload("x")) is FailureKind.CORRUPT
    for exc in (TypeError("t"), ValueError("v"), KeyError("k"),
                IndexError("i"), AttributeError("a"), AssertionError("s"),
                NameError("n"), ZeroDivisionError("z")):
        assert classify_failure(exc) is FailureKind.DETERMINISTIC, exc
    for exc in (TransientFault("gone"), OSError("io"), TimeoutError("slow"),
                RuntimeError("unknown")):
        assert classify_failure(exc) is FailureKind.TRANSIENT, exc


def test_retry_policy_backoff_bounded():
    p = RetryPolicy(backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.5)
    assert p.backoff(1) == pytest.approx(0.1)
    assert p.backoff(2) == pytest.approx(0.2)
    assert p.backoff(4) == pytest.approx(0.5)
    assert p.backoff(10) == pytest.approx(0.5)


def test_corrupt_payload_raised_on_distributed_tamper(db):
    """A bit flipped in a real packed exchange's received buffer surfaces
    as CorruptPayload, never as a result."""
    class OneFlip:
        def fire(self, cut, ctx, tamperable=False):
            if cut == "group_by" and tamperable:
                def tamper(p):
                    flat = p.reshape(-1).clone()
                    flat[flat.shape[0] // 2] ^= 1 << 21
                    return flat.reshape(p.shape)
                return tamper
            return None

    with pytest.raises(W.CorruptPayload):
        B.run_distributed(QUERIES[13], db, 2, capacity_factor=3.0,
                          chaos=OneFlip(), device="cpu")


def test_local_run_raises_on_simulated_corruption(db):
    inj = ChaosInjector(FaultPlan(1, (FaultSpec("corrupt", cut="group_by"),)))
    with pytest.raises(W.CorruptPayload, match="local run"):
        B.run_local(QUERIES[1], db, chaos=inj, device="cpu")
    assert inj.events[0].simulated


def test_deterministic_error_raises_on_attempt_1(db):
    inj = ChaosInjector(FaultPlan(1, (
        FaultSpec("deterministic", cut="scan", attempt=1),)))
    runner = QueryRunner(db, 2, capacity_factor=3.0, max_attempts=6,
                         chaos=inj, device="cpu")
    with pytest.raises(ValueError, match="plan bug"):
        runner.run(QUERIES[6])
    assert len(inj.events) == 1
    assert runner.chaos.events[0].kind == "deterministic"


def test_corrupt_forces_wide_rerun(db):
    inj = ChaosInjector(FaultPlan(9, (
        FaultSpec("corrupt", cut="group_by", attempt=1),)))
    runner = QueryRunner(db, 4, capacity_factor=3.0, wire_format="narrow",
                         chaos=inj, device="cpu",
                         policy=RetryPolicy(max_attempts=4, backoff_s=0.01))
    res = runner.run(QUERIES[13])
    rows = res.report.rows()
    assert [r["outcome"] for r in rows] == ["corrupt", "ok"]
    assert rows[0]["wire_format"] == "narrow"
    assert rows[1]["wire_format"] == "wide"
    assert rows[0]["cut"] == "group_by"
    assert not res.report.injected[0].simulated     # a real flip, caught
    json.dumps(rows)                                # the audit is JSON-able


def test_transient_retries_with_backoff(db):
    inj = ChaosInjector(FaultPlan(4, (
        FaultSpec("transient", cut="scan", attempt=1),
        FaultSpec("transient", cut="scan", attempt=2),)))
    runner = QueryRunner(db, 2, capacity_factor=3.0, chaos=inj, device="cpu",
                         policy=RetryPolicy(max_attempts=4, backoff_s=0.01,
                                            backoff_mult=3.0))
    res = runner.run(QUERIES[6])
    rows = res.report.rows()
    assert [r["outcome"] for r in rows] == ["transient", "transient", "ok"]
    assert rows[0]["backoff_s"] == pytest.approx(0.01)
    assert rows[1]["backoff_s"] == pytest.approx(0.03)
    assert res.attempts == 3


def test_transient_exhaustion_reraises(db):
    inj = ChaosInjector(FaultPlan(4, tuple(
        FaultSpec("transient", cut="scan", attempt=a) for a in (1, 2))))
    runner = QueryRunner(db, 2, capacity_factor=3.0, chaos=inj, device="cpu",
                         policy=RetryPolicy(max_attempts=2, backoff_s=0.01))
    with pytest.raises(TransientFault):
        runner.run(QUERIES[6])


def test_runner_without_a_group_runs_locally(db):
    """``group=None``: the single-device path under the same policy."""
    runner = QueryRunner(db, None, capacity_factor=1.5, device="cpu",
                         chaos=ChaosInjector(FaultPlan.default(11)),
                         policy=RetryPolicy(max_attempts=6, backoff_s=0.01))
    res = runner.run(QUERIES[9])
    assert res.report.outcomes() == ["transient", "corrupt", "overflow",
                                     "ok"]
    assert runner.devices == 1
    clean, _ = B.run_local(QUERIES[9], db, capacity_factor=3.0,
                           wire_format="wide", device="cpu")
    for k in clean:
        assert np.array_equal(clean[k], res.result[k]), k


@pytest.mark.parametrize("infer", [True, False])
def test_chaos_differential_sweep(db, infer):
    """Under the default seeded FaultPlan (one transient + one corrupt +
    one overflow) every query recovers to a result byte-identical to the
    fault-free run with the final attempt's wire format and capacity
    factor, on both planner legs."""
    group = comm.ThreadGroup(4, "cpu")
    for qid in [1, 6, 9, 13, 18]:
        q = QUERIES[qid].with_inference(infer)
        runner = QueryRunner(db, group, capacity_factor=1.5, escalation=2.0,
                             chaos=ChaosInjector(FaultPlan.default(11)),
                             policy=RetryPolicy(max_attempts=6,
                                                backoff_s=0.01))
        res = runner.run(q)
        outcomes = res.report.outcomes()
        assert outcomes == ["transient", "corrupt", "overflow", "ok"], \
            (qid, outcomes)
        kinds = [f.kind for f in res.report.injected]
        assert kinds == ["transient", "corrupt", "overflow"], (qid, kinds)
        last = res.report.attempts[-1]
        assert (last.capacity_factor, last.wire_format) == (3.0, "wide")
        clean, _, ov = B.run_distributed(q, db, group, capacity_factor=3.0,
                                         wire_format="wide")
        assert not ov, qid
        assert set(clean) == set(res.result), qid
        for k in clean:
            np.testing.assert_array_equal(clean[k], res.result[k],
                                          err_msg=f"q{qid} {k} {infer}")


# ---------------------------------------------------------------------------
# lineage snapshots
# ---------------------------------------------------------------------------

def test_lineage_resume_skips_subtree(db, tmp_path):
    """Fail at finalize -> every exchange is durable -> the retry restores
    the topmost snapshot and re-executes only the suffix."""
    q = QUERIES[9]
    store = LineageStore(str(tmp_path / "lin"))
    inj = ChaosInjector(FaultPlan(3, (
        FaultSpec("transient", cut="finalize", attempt=1),)))
    with pytest.raises(TransientFault):
        run_resumable(q, db, store, capacity_factor=3.0, chaos=inj,
                      device="cpu")
    assert store.saved >= 1
    inj.begin_attempt(2)
    r, stats, ov, reused = run_resumable(q, db, store, capacity_factor=3.0,
                                         chaos=inj, device="cpu")
    assert not ov and reused >= 1
    assert stats.shuffles == 0 and stats.broadcasts == 0
    clean, _ = B.run_local(q, db, capacity_factor=3.0, device="cpu")
    for k in clean:
        assert np.array_equal(r[k], clean[k]), k


def test_lineage_config_leg_invalidates(db, tmp_path):
    q = QUERIES[9]
    store = LineageStore(str(tmp_path / "lin"))
    run_resumable(q, db, store, capacity_factor=3.0, wire_format="narrow",
                  device="cpu")
    assert store.saved >= 1
    _, _, ov, reused = run_resumable(q, db, store, capacity_factor=3.0,
                                     wire_format="wide", device="cpu")
    assert reused == 0 and not ov
    _, _, ov2, reused2 = run_resumable(q.with_inference(False), db, store,
                                       capacity_factor=3.0,
                                       wire_format="narrow", device="cpu")
    assert reused2 == 0 and not ov2


def test_lineage_torn_snapshot_falls_back(db, tmp_path):
    q = QUERIES[9]
    store = LineageStore(str(tmp_path / "lin"))
    r1, _, _, _ = run_resumable(q, db, store, capacity_factor=3.0,
                                device="cpu")
    for step in sorted(os.listdir(store.dir)):
        leaf = os.path.join(store.dir, step, "000000.npy")
        with open(leaf, "r+b") as f:
            f.seek(-2, 2)
            b = f.read(1)
            f.seek(-2, 2)
            f.write(bytes([b[0] ^ 0xFF]))
    r2, _, ov, reused = run_resumable(q, db, store, capacity_factor=3.0,
                                      device="cpu")
    assert reused == 0 and not ov
    for k in r1:
        assert np.array_equal(r1[k], r2[k]), k


def test_runner_with_lineage_resumes(db, tmp_path):
    """The runner's lineage rung: attempt 2 after a finalize fault resumes
    from the snapshots attempt 1 wrote."""
    store = LineageStore(str(tmp_path / "lin"))
    inj = ChaosInjector(FaultPlan(3, (
        FaultSpec("transient", cut="finalize", attempt=1),)))
    runner = QueryRunner(db, None, chaos=inj, lineage=store, device="cpu",
                         policy=RetryPolicy(max_attempts=3, backoff_s=0.0))
    res = runner.run(QUERIES[5])
    rows = res.report.rows()
    assert [r["outcome"] for r in rows] == ["transient", "ok"]
    assert rows[1]["snapshots_reused"] >= 1
    clean, _ = B.run_local(QUERIES[5], db, device="cpu")
    for k in clean:
        assert np.array_equal(clean[k], res.result[k]), k


# ---------------------------------------------------------------------------
# the same plans on the reference's runner, over a 4-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "ref.npz"
    return cases.finish_reference(cases.start_reference(out, DIFF_CASES),
                                  out)


@pytest.mark.parametrize("name,qid,kind,seed,factor", DIFF_CASES,
                         ids=[c[0] for c in DIFF_CASES])
def test_same_plan_as_the_reference(db, reference_runs, name, qid, kind,
                                    seed, factor):
    meta, arrays = reference_runs
    runner = QueryRunner(db, 4, capacity_factor=factor, device="cpu",
                         chaos=ChaosInjector(cases.plan(chaos, kind, seed)),
                         policy=RetryPolicy(max_attempts=6, backoff_s=0.0))
    res = runner.run(QUERIES[qid])
    assert cases.record(runner, res) == meta[name]
    cases.assert_same_result(res.result, arrays, name)
