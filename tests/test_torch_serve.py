"""The port's serving layer (``repro_torch.serve``) against the reference's
(``repro.serve``): the cases of tests/test_serve.py and the three serving
cases of tests/test_degraded.py, on the CPU (``device="cpu"``), plus the
cross-package checks — template signatures equal the reference's, served
results equal the reference's ``QueryServer`` (integers exactly, floats
within rtol 1e-7), and a rung's device tables reuse the base's tensors.

The reference counts ``jax.jit`` traces; the port's engine is eager, so
``recompiles`` counts preparations (PlanInfo + plan + settings closed over
by a run function), one per template and configuration."""
import numpy as np
import pytest
import torch

from repro import serve as rserve
from repro.data import tpch as rtpch
from repro_torch import serve
from repro_torch.approx import sampling
from repro_torch.core import backend as B
from repro_torch.core import plan as P
from repro_torch.core import planner
from repro_torch.core.plan import col, param, scan
from repro_torch.core.planner import (ColStats, params_of, plan_signature,
                                      subplan_signatures)
from repro_torch.core.table import database_from, days
from repro_torch.data import tpch
from repro_torch.distributed.lineage import (LineageStore, plan_fingerprint,
                                             run_resumable)
from repro_torch.queries import QUERIES
from repro_torch.serve import AdmissionGate, Degraded, QueryServer, Served, \
    Shed

CPU = "cpu"
FAST_QIDS = (1, 3, 5, 6, 9, 13, 18)


@pytest.fixture(scope="module")
def rdb():
    return rtpch.generate(0.005, seed=11)


@pytest.fixture(scope="module")
def db(rdb):
    return database_from(rdb)


@pytest.fixture(scope="module")
def db_small():
    return tpch.generate(0.002, seed=11)


def _requests(qids):
    """Mixed interleaved parameterized stream: every sample of every qid,
    round-robin across queries (template changes request-to-request)."""
    per = [[(serve.TEMPLATES[q], s) for s in serve.TEMPLATES[q].samples]
           for q in qids]
    out, i = [], 0
    while any(per):
        if per[i % len(per)]:
            out.append(per[i % len(per)].pop(0))
        i += 1
    return out


def _local(bound, db, **kw):
    return B.run_local(bound, db, device=CPU, **kw)[0]


def _same_bytes(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert got[k].tobytes() == want[k].tobytes(), (label, k)


# ---------------------------------------------------------------------------
# templates against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qid", range(1, 23))
def test_template_signature_equals_the_reference(qid):
    t, rt = serve.TEMPLATES[qid], rserve.TEMPLATES[qid]
    assert t.signature() == rt.signature()
    assert t.name == rt.name and t.samples == rt.samples
    assert {n: (p.dtype, p.lo, p.hi, p.default)
            for n, p in t.params.items()} == \
        {n: (p.dtype, p.lo, p.hi, p.default) for n, p in rt.params.items()}
    assert serve.template_for(qid) is t


def test_exports_equal_the_reference():
    import repro.approx as rapprox
    import repro_torch.approx as approx
    assert serve.__all__ == rserve.__all__
    assert approx.__all__ == rapprox.__all__


# ---------------------------------------------------------------------------
# fingerprint: content, not shape
# ---------------------------------------------------------------------------

def _shape_twin_a():
    return scan("lineitem").filter(col("l_quantity") < 10) \
        .group_by(["l_returnflag"], [("s", "sum", "l_quantity")],
                  exchange="gather", final=True) \
        .finalize(sort_keys=[("l_returnflag", True)], replicated=True)


def _shape_twin_b():
    return scan("lineitem").filter(col("l_discount") < 10) \
        .group_by(["l_linestatus"], [("s", "sum", "l_extendedprice")],
                  exchange="gather", final=True) \
        .finalize(sort_keys=[("l_linestatus", True)], replicated=True)


def test_fingerprint_distinguishes_same_shaped_plans():
    a, b = planner.walk(_shape_twin_a()), planner.walk(_shape_twin_b())
    assert [type(n).__name__ for n in a] == [type(n).__name__ for n in b]
    assert plan_fingerprint(a) != plan_fingerprint(b)
    assert plan_signature(_shape_twin_a()) != plan_signature(_shape_twin_b())


def test_fingerprint_stable_across_rebuilds():
    assert plan_fingerprint(planner.walk(_shape_twin_a())) == \
        plan_fingerprint(planner.walk(_shape_twin_a()))


def test_fingerprint_distinguishes_bindings():
    t = serve.TEMPLATES[1]
    nodes = planner.walk(t.query.plan)
    b0 = t.bind().values
    b1 = t.bind(q1_cutoff=days("1998-08-15")).values
    assert plan_fingerprint(nodes, b0) != plan_fingerprint(nodes, b1)
    # canonical across host scalar types and the served 0-d tensors
    assert plan_fingerprint(nodes, {"q1_cutoff": np.int64(10448)}) == \
        plan_fingerprint(nodes, {"q1_cutoff": 10448}) == \
        plan_fingerprint(nodes, {"q1_cutoff": torch.tensor(10448)})


def test_fingerprint_distinguishes_dag_sharing():
    def sel():
        return scan("orders").select("o_orderkey", "o_custkey")
    s = sel()
    dag = s.join(s, "o_custkey", "o_orderkey", ["o_orderkey"])
    tree = sel().join(sel(), "o_custkey", "o_orderkey", ["o_orderkey"])
    assert plan_signature(dag) != plan_signature(tree)


def test_bindings_never_exchange_snapshots(db, tmp_path):
    """Two bindings of one template run through one LineageStore directory:
    the second run must NOT resume from the first's snapshots."""
    t = serve.TEMPLATES[1]
    store = LineageStore(str(tmp_path / "lineage"))
    r_a, _, overflow, reused_a = run_resumable(t.bind(), db, store,
                                               device=CPU)
    assert not overflow and reused_a == 0 and store.saved > 0
    _, _, _, reused_again = run_resumable(t.bind(), db, store, device=CPU)
    assert reused_again > 0
    bound_b = t.bind(q1_cutoff=days("1998-08-15"))
    r_b, _, _, reused_b = run_resumable(bound_b, db, store, device=CPU)
    assert reused_b == 0, "cross-binding snapshot reuse: silent wrong answer"
    _same_bytes(r_b, _local(bound_b, db), "q1 binding b")
    assert not np.array_equal(r_a["count_order"], r_b["count_order"])


# ---------------------------------------------------------------------------
# templates: domain-sound refinement + bind validation
# ---------------------------------------------------------------------------

def test_refinement_uses_weakest_domain_bound(db):
    sch = {"x": ColStats(0, 100, 101)}
    p = param("p", lo=10, hi=20)
    le = planner._refine_filter(col("x") <= p, sch, db)["x"]
    assert (le.lo, le.hi) == (0, 20)
    ge = planner._refine_filter(col("x") >= p, sch, db)["x"]
    assert (ge.lo, ge.hi) == (10, 100)
    eq = planner._refine_filter(col("x") == p, sch, db)["x"]
    assert (eq.lo, eq.hi, eq.card) == (10, 20, 11)
    free = planner._refine_filter(col("x") <= param("q"), sch, db)["x"]
    assert (free.lo, free.hi) == (0, 100)
    lit = planner._refine_filter(col("x") <= 42, sch, db)["x"]
    assert lit.hi == 42


def test_template_info_sound_for_every_binding(db):
    """Claims derived from the parameter DOMAINS hold at the extreme
    admissible bindings: inference on runs them without overflow
    (``run_local`` raises on one) and equals the no-hints execution."""
    t = serve.TEMPLATES[1]
    lo_dom, hi_dom = t.params["q1_cutoff"].lo, t.params["q1_cutoff"].hi
    for cutoff in (lo_dom, hi_dom):
        bound = t.bind(q1_cutoff=cutoff)
        _same_bytes(_local(bound.with_inference(True), db),
                    _local(bound.with_inference(False), db), cutoff)


def test_bind_validation():
    t = serve.TEMPLATES[6]
    with pytest.raises(ValueError, match="unknown parameter"):
        t.bind(nope=3)
    with pytest.raises(ValueError, match="outside its declared domain"):
        t.bind(q6_qty=50)
    with pytest.raises(ValueError, match="int64"):
        t.bind(q6_qty=24.5)
    with pytest.raises(ValueError, match="expected a number"):
        t.bind(q6_qty="24")
    assert t.bind(q6_qty=24.0).values["q6_qty"] == 24
    bare = serve.PlanTemplate(
        lambda: scan("lineitem").filter(col("l_quantity") < param("k"))
        .agg_scalar([("n", "count", None)]), name="bare")
    with pytest.raises(ValueError, match="no binding and no default"):
        bare.bind()


@pytest.mark.parametrize("bindings", [
    {"nope": 3}, {"q6_qty": 50}, {"q6_qty": 24.5}, {"q6_qty": "24"},
    {"q6_disc_lo": 0.0}, {"q6_date_hi": days("1999-01-01")}])
def test_bind_errors_equal_the_reference(bindings):
    with pytest.raises(ValueError) as got:
        serve.TEMPLATES[6].bind(**bindings)
    with pytest.raises(ValueError) as want:
        rserve.TEMPLATES[6].bind(**bindings)
    assert str(got.value) == str(want.value)


def test_param_spec_conflict_detected():
    a = param("k", lo=0, hi=10)
    b = param("k", lo=0, hi=99)
    plan = scan("lineitem").filter((col("l_quantity") < a) &
                                   (col("l_linenumber") < b)) \
        .agg_scalar([("n", "count", None)])
    with pytest.raises(ValueError, match="conflicting declarations"):
        params_of(plan)


def test_param_domain_validation():
    with pytest.raises(ValueError, match="both lo and hi"):
        param("p", lo=3)
    with pytest.raises(ValueError, match="empty domain"):
        param("p", lo=5, hi=4)
    with pytest.raises(ValueError, match="unsupported dtype"):
        param("p", dtype="int32")
    assert param("p", lo=0.0, hi=1.0).dtype == "float64"
    assert param("p", lo=0, hi=1).dtype == "int64"


def test_subplan_signatures_content_addressed():
    t = serve.TEMPLATES[6]
    subs = subplan_signatures(t.query.plan)
    assert subs[id(t.query.plan)][1] == frozenset(t.params)
    scans = [n for n in planner.walk(t.query.plan)
             if isinstance(n, P.Scan)]
    assert all(subs[id(s)][1] == frozenset() for s in scans)
    twin = subplan_signatures(serve.PlanTemplate(
        serve.templates._q6_template, name="q6twin").query.plan)
    assert {h for h, _ in subs.values()} == {h for h, _ in twin.values()}


# ---------------------------------------------------------------------------
# the prepared-template cache: one preparation per template, FIFO,
# invalidation
# ---------------------------------------------------------------------------

def test_one_preparation_per_template_across_bindings(db):
    srv = QueryServer(db, device=CPU)
    reqs = _requests((1, 6))         # 3 + 3 samples, interleaved
    got = srv.serve(reqs, infer=True)
    assert srv.recompiles == 2, "re-binding must never re-prepare"
    assert srv.cache_hits == len(reqs) - 2
    # the prepared path equals an eager run of the same binding, byte for
    # byte (bindings enter as 0-d tensors, run_local's as Python numbers)
    for (t, s), out in zip(reqs, got):
        _same_bytes(out, _local(t.bind(**s).with_inference(True), db),
                    (t.name, s))


def test_bindings_enter_as_pinned_device_tensors(db):
    srv = QueryServer(db, device=CPU)
    pv = srv._pvals(serve.TEMPLATES[6],
                    serve.TEMPLATES[6].bind(q6_qty=25).values)
    assert pv["q6_qty"].dtype == torch.int64 and pv["q6_qty"].ndim == 0
    assert pv["q6_disc_lo"].dtype == torch.float64
    assert all(v.device.type == "cpu" for v in pv.values())


def test_plancache_fifo_bound(db):
    cache = serve.PlanCache(max_entries=2)
    cache.put(db, "a", 1)
    cache.put(db, "b", 2)
    cache.put(db, "c", 3)            # evicts "a" (FIFO)
    assert cache.get(db, "a") is None
    assert cache.get(db, "b") == 2 and cache.get(db, "c") == 3
    assert len(cache) == 2 and cache.evictions == 1
    with pytest.raises(ValueError):
        serve.PlanCache(max_entries=0)


def test_stats_override_evicts_prepared_templates(db):
    srv = QueryServer(db, device=CPU)
    srv.submit(6, infer=True)
    assert srv.recompiles == 1 and len(srv.cache) == 1
    with planner.stats_override(db, {}):
        assert len(srv.cache) == 0
        srv.submit(6, infer=True)
        assert srv.recompiles == 2
    assert len(srv.cache) == 0
    srv.submit(6, infer=True)
    assert srv.recompiles == 3


def test_table_mutation_evicts_prepared_templates():
    db2 = tpch.generate(0.002, seed=3)
    srv = QueryServer(db2, device=CPU)
    before = srv.submit(6, infer=True)
    assert srv.recompiles == 1
    li = db2.tables["lineitem"]
    li["l_quantity"] = np.minimum(np.asarray(li["l_quantity"]), 10)
    planner.invalidate_stats(db2)
    assert len(srv.cache) == 0, "stale template would serve wrong answers"
    srv2 = QueryServer(db2, device=CPU)   # tables held at server build
    after = srv2.submit(6, infer=True)
    assert srv2.recompiles == 1
    assert not np.array_equal(before["revenue"], after["revenue"])
    # the old server keeps the tensors it was built with, the new one
    # holds the upload run_local shares
    assert srv._tables is not srv2._tables
    assert srv2._tables is B.device_tables(db2, torch.device(CPU))


def test_invalidation_scoped_to_the_database(db):
    db2 = tpch.generate(0.002, seed=3)
    srv = QueryServer(db, device=CPU)
    srv.submit(6, infer=True)
    planner.invalidate_stats(db2)
    assert len(srv.cache) == 1, "foreign invalidation must not evict"


def test_server_runs_on_cuda_unless_told(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: QueryServer(db), lambda: serve.BatchExecutor(db)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ---------------------------------------------------------------------------
# served results against the reference's QueryServer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(rdb, db):
    """Every sample of all 22 templates, through both packages' servers."""
    reqs = _requests(range(1, 23))
    srv, rsrv = QueryServer(db, device=CPU), rserve.QueryServer(rdb)
    got = {(t.name, i): srv.submit(t, s, infer=True)
           for i, (t, s) in enumerate(reqs)}
    want = {(t.name, i): rsrv.submit(rserve.TEMPLATES[int(t.name[1:])], s,
                                     infer=True)
            for i, (t, s) in enumerate(reqs)}
    return reqs, got, want, srv


@pytest.mark.parametrize("qid", range(1, 23))
def test_served_results_equal_the_reference(served, qid):
    reqs, got, want, _ = served
    keys = [k for k in got if k[0] == f"q{qid}"]
    assert keys
    for key in keys:
        g, w = got[key], {k: np.asarray(v) for k, v in want[key].items()}
        assert set(g) == set(w), key
        for k in w:
            assert g[k].shape == w[k].shape, (key, k)
            if np.issubdtype(w[k].dtype, np.floating):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-7,
                                           err_msg=f"{key} {k}")
            else:
                assert np.array_equal(g[k], w[k]), (key, k)


def test_served_stream_prepares_each_template_once(served):
    reqs, _, _, srv = served
    assert srv.recompiles == 22
    assert srv.cache_hits == len(reqs) - 22


# ---------------------------------------------------------------------------
# batch executor: differential vs sequential + sharing + overflow isolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("infer,wire", [(True, "narrow"), (True, "wide"),
                                        (False, "narrow")])
def test_batch_differential_fast(db, infer, wire):
    """Mixed interleaved parameterized stream through the batch executor ==
    each request run alone, byte-identical, on both planner legs and both
    wire legs."""
    reqs = _requests(FAST_QIDS)
    bx = serve.BatchExecutor(db, wire_format=wire, device=CPU)
    got = bx.run_batch(reqs, infer=infer)
    assert bx.shared_hits > 0, "no cross-query sharing happened"
    for (t, s), out in zip(reqs, got):
        _same_bytes(out, _local(t.bind(**s).with_inference(infer), db,
                                wire_format=wire), (t.name, infer, wire))


def test_batch_differential_all22(db):
    reqs = _requests(range(1, 23))
    bx = serve.BatchExecutor(db, device=CPU)
    got = bx.run_batch(reqs, infer=True)
    for (t, s), out in zip(reqs, got):
        _same_bytes(out, _local(t.bind(**s).with_inference(True), db),
                    t.name)


def _lying_template():
    """groups_hint=2 undercounts orders wildly: the hash-compaction
    dictionary overflows at any sane capacity factor."""
    g = scan("orders").group_by(["o_custkey", "o_orderkey"],
                                [("n", "count", None)],
                                exchange="gather", final=True, groups_hint=2)
    return g.finalize(replicated=True)


def test_server_overflow_recovers_conservatively(db):
    lying = serve.PlanTemplate(_lying_template, name="lying")
    srv = QueryServer(db, device=CPU)
    out = srv.submit(lying, infer=True)
    assert srv.overflow_reruns == 1
    assert out["n"].size == np.asarray(
        db.tables["orders"]["o_orderkey"]).size
    assert (out["n"] >= 1).all()


def test_batch_overflow_isolated(db):
    lying = serve.PlanTemplate(_lying_template, name="lying")
    t6, t1 = serve.TEMPLATES[6], serve.TEMPLATES[1]
    reqs = [(t6, {}), (lying, {}), (t1, {"q1_cutoff": days("1998-08-15")})]
    bx = serve.BatchExecutor(db, device=CPU)
    got = bx.run_batch(reqs, infer=True)
    assert bx.overflow_reruns == 1
    assert got[1]["n"].size == np.asarray(
        db.tables["orders"]["o_orderkey"]).size
    for (t, s), out in ((reqs[0], got[0]), (reqs[2], got[2])):
        _same_bytes(out, _local(t.bind(**s).with_inference(True), db),
                    t.name)


# ---------------------------------------------------------------------------
# fault runner integration, literal queries
# ---------------------------------------------------------------------------

def test_query_runner_accepts_template_bindings(db, tmp_path):
    from repro_torch.distributed.fault import QueryRunner
    runner = QueryRunner(db, None, device=CPU,
                         lineage=LineageStore(str(tmp_path / "ln")))
    runner.chaos = None              # pin: no env-leg injection here
    rr = runner.run(serve.TEMPLATES[6],
                    bindings={"q6_disc_lo": 0.03, "q6_disc_hi": 0.05})
    _same_bytes(rr.result, _local(serve.TEMPLATES[6].bind(
        q6_disc_lo=0.03, q6_disc_hi=0.05), db), "q6")
    with pytest.raises(TypeError, match="plan template"):
        runner.run(QUERIES[6], bindings={"q6_qty": 24})


def test_query_runner_binds_on_a_thread_group(db):
    from repro_torch.distributed.fault import QueryRunner
    runner = QueryRunner(db, 2, device=CPU)
    runner.chaos = None
    rr = runner.run(serve.TEMPLATES[1],
                    bindings={"q1_cutoff": days("1998-08-15")})
    want = _local(serve.TEMPLATES[1].bind(q1_cutoff=days("1998-08-15")), db)
    assert set(rr.result) == set(want)
    for k in want:
        np.testing.assert_allclose(rr.result[k], want[k], rtol=1e-7)


def test_default_bindings_match_literal_queries(db):
    """samples[0] (all defaults) reproduces the literal query byte-for-byte
    for every parameterized template."""
    for qid in (1, 3, 5, 6):
        t = serve.TEMPLATES[qid]
        _same_bytes(_local(t.bind().with_inference(False), db),
                    _local(QUERIES[qid].with_inference(False), db), qid)


# ---------------------------------------------------------------------------
# serving on a degraded topology
# ---------------------------------------------------------------------------

def test_server_reprepares_once_per_topology_generation(db_small):
    srv = QueryServer(db_small, devices=8, device=CPU)
    srv.submit(1, {})
    srv.submit(1, {})
    base = srv.recompiles
    assert base == 1
    gen = srv.degrade(6)
    assert gen == 1 and srv.devices == 6
    srv.submit(1, {})
    srv.submit(1, {})
    assert srv.recompiles == base + 1
    srv.degrade(6)
    assert srv.topology_generation == 1
    srv.restore()
    assert srv.devices == 8 and srv.topology_generation == 2
    with pytest.raises(ValueError):
        srv.degrade(9)


def test_server_sheds_and_drains_structured_outcomes(db_small):
    fits_at_8 = QueryServer(db_small, devices=8,
                            device=CPU).footprint_bytes()
    gate = AdmissionGate(hbm_bytes=fits_at_8 * 2.5, headroom=1.0)
    srv = QueryServer(db_small, devices=8, gate=gate, device=CPU)
    out = srv.submit_guarded(1, {})
    assert isinstance(out, Served) and out.devices == 8
    srv.degrade(2)
    out = srv.submit_guarded(1, {})
    assert isinstance(out, Shed) and out.queued
    assert out.estimated_bytes > out.budget_bytes
    assert "footprint" in out.reason and len(srv.backlog) == 1
    assert srv.shed_count == 1
    out2 = srv.submit_guarded(1, {}, queue=False)
    assert isinstance(out2, Shed) and not out2.queued
    assert len(srv.backlog) == 1
    srv.restore()
    drained = srv.drain_backlog()
    assert len(drained) == 1 and isinstance(drained[0], Served)
    assert srv.backlog == []
    _same_bytes(drained[0].result, srv.submit(1, {}), "q1 drained")


def test_footprint_equals_the_reference(rdb, db):
    for devices in (1, 3, 8):
        assert QueryServer(db, devices=devices, device=CPU) \
            .footprint_bytes(1.5) == \
            rserve.QueryServer(rdb, devices=devices).footprint_bytes(1.5)


def test_server_degraded_outcome_same_answer(db_small):
    srv = QueryServer(db_small, devices=8, device=CPU)
    full = srv.submit_guarded(5, {})
    assert isinstance(full, Served)
    srv.degrade(5)
    deg = srv.submit_guarded(5, {})
    assert isinstance(deg, Degraded)
    assert deg.devices == 5 and deg.lost == 3 and deg.generation == 1
    _same_bytes(deg.result, full.result, "q5 degraded")


# ---------------------------------------------------------------------------
# a rung's device tables: the base's resident tensors plus the sample
# ---------------------------------------------------------------------------

def test_rung_device_tables_reuse_the_base_tensors(db_small):
    dev = torch.device(CPU)
    base = B.device_tables(db_small, dev)
    rdb = sampling.rung_database(db_small, "lineitem",
                                 ("l_returnflag", "l_linestatus"), 4)
    name = sampling.rung_name("lineitem", 4)
    rung = B.device_tables(rdb, dev)
    assert set(rung) == set(base) | {name}
    assert all(rung[t] is base[t] for t in base)
    assert rung[name].capacity >= len(rdb.tables[name]["__sw"])
    # shards too: only the sample is partitioned anew
    shards = B.device_shards(db_small, dev, 2)
    rshards = B.device_shards(rdb, dev, 2)
    assert all(rshards[d][t] is shards[d][t] for d in (0, 1) for t in base)
    # one invalidation drops the base's tables and the rung's with them
    planner.invalidate_stats(db_small)
    assert "_device_tables" not in rdb.__dict__
    assert sampling.rung_database(db_small, "lineitem",
                                  ("l_returnflag", "l_linestatus"), 4) \
        is not rdb
    sampling.invalidate(db_small)


def test_result_table_shapes_a_scalar_result():
    out = B.result_table({"a": torch.tensor(3), "b": 2.5},
                         torch.device(CPU))
    assert out.capacity == 1 and int(out.count) == 1
    assert out["b"].dtype == torch.float64
