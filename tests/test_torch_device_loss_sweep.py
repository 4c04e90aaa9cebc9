"""All 22 TPC-H queries survive a device loss mid-query on the port's
8-rank ``ThreadGroup`` on the CPU, on both planner legs and both wire
formats, shrinking 8->7 and 8->4 (the reference's
tests/test_device_loss_sweep.py, without its subprocesses: a ThreadGroup
needs no virtual devices).

Each query: attempt 1 dies with ``DeviceLost`` at a chaos cut; the runner
shrinks the group to the survivors, bumps the topology generation and
re-executes; the recovered answer is byte-identical to a clean run on a
group of the surviving width and matches the port's NumPy reference to
rtol 1e-7.  The 8->7 legs arm the fault through the ``REPRO_CHAOS`` ``lose=``
grammar (the runner's default injector), the 8->4 legs through an explicit
seeded-random plan."""
import numpy as np
import pytest

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.data import tpch
from repro_torch.distributed.chaos import ChaosInjector, FaultPlan
from repro_torch.distributed.fault import QueryRunner
from repro_torch.queries import QUERIES


@pytest.fixture(scope="module")
def db():
    return tpch.generate(0.005, seed=11)


@pytest.fixture(scope="module")
def refs(db):
    return {qid: B.run_reference(QUERIES[qid], db)[0] for qid in QUERIES}


def _sweep(db, refs, injector_for, expect_devices, infer, wire):
    for qid in sorted(QUERIES):
        q = QUERIES[qid].with_inference(infer)
        runner = QueryRunner(db, comm.ThreadGroup(8, "cpu"),
                             capacity_factor=3.0, wire_format=wire,
                             chaos=injector_for(qid))
        res = runner.run(q)
        outs = res.report.outcomes()
        assert outs == ["device_lost", "ok"], (qid, outs)
        assert runner.devices == expect_devices, (qid, runner.devices)
        assert runner.topology_generation == 1
        assert res.report.attempts[-1].devices == expect_devices
        clean, _, ov = B.run_distributed(
            q, db, comm.ThreadGroup(expect_devices, "cpu"),
            capacity_factor=3.0, wire_format=wire)
        assert not ov, qid
        assert set(res.result) == set(clean), qid
        for k in res.result:
            a, b = res.result[k], clean[k]
            assert a.dtype == b.dtype and np.array_equal(a, b), (qid, k)
        for k in set(refs[qid]) & set(res.result):
            np.testing.assert_allclose(
                np.asarray(res.result[k], np.float64),
                np.asarray(refs[qid][k], np.float64), rtol=1e-7,
                err_msg=f"q{qid} {k}")


@pytest.mark.parametrize("infer,wire", [(True, "narrow"), (False, "wide")])
def test_device_loss_8_to_7_env_grammar(db, refs, monkeypatch, infer, wire):
    """8->7: rank 3 dies at the first scan, armed through
    ``REPRO_CHAOS=5,lose=3@scan`` (the runner's default injector)."""
    monkeypatch.setenv("REPRO_CHAOS", "5,lose=3@scan")
    _sweep(db, refs, lambda qid: None, 7, infer, wire)


@pytest.mark.parametrize("infer,wire", [(True, "wide"), (False, "narrow")])
def test_device_loss_8_to_4_seeded_random(db, refs, monkeypatch, infer,
                                          wire):
    """8->4: four seeded-random ranks die at the aggregation cut, the late
    cut every query reaches (group_by, or agg_scalar for scalar plans)."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    _sweep(db, refs, lambda qid: ChaosInjector(
        FaultPlan.device_loss(1000 + qid, n_lost=4, cut="group_by")),
        4, infer, wire)
