"""The port's approximate answers (``repro_torch.approx``) against the
reference's (``repro.approx``): the cases of tests/test_approx.py on the
CPU (``device="cpu"``), under its ``approx`` marker and ``APPROX_SEED``,
plus the cross-package checks — every rung's ``stratified_selection`` and
``sample_table`` byte-identical to the reference's, the estimators' numbers
and the coverage rates equal to the reference's, every rewrite with the
reference's ``plan_signature`` and refusals, and served and progressive
answers equal to the reference's (integers exactly, floats rtol 1e-7).

The reference's ``test_rung1_byte_identity_jitted`` has no counterpart: the
port's engine is eager (no ``jit=``), and ``test_rung1_byte_identity`` is
the one path it has."""
import json

import numpy as np
import pytest
import torch

from repro.approx import estimators as restimators
from repro.approx import progressive as rprogressive
from repro.approx import rewrite as rrewrite
from repro.approx import sampling as rsampling
from repro.core import backend as RB
from repro.core import planner as RPL
from repro.data import tpch as rtpch
from repro.queries import QUERIES as RQUERIES
from repro_torch.approx import estimators, progressive, sampling
from repro_torch.approx.rewrite import rewrite_for_rung
from repro_torch.core import backend as B
from repro_torch.core import plan as P
from repro_torch.core import planner
from repro_torch.core.plan import col, scan
from repro_torch.core.table import Database, database_from
from repro_torch.queries import QUERIES
from repro_torch.serve import TEMPLATES

from conftest import APPROX_SEED

pytestmark = pytest.mark.approx

CPU = "cpu"
SMOKE_TRIALS = 20     # the reference's tier-1 smoke and full sweep
FULL_TRIALS = 200
DENS = (16, 8, 4, 2)  # rung 1 is exact by construction — tested for identity


@pytest.fixture(scope="module")
def rdb():
    return rtpch.generate(0.005, seed=11)


@pytest.fixture(scope="module")
def db(rdb):
    return database_from(rdb)


def _local(q, db, **kw):
    return B.run_local(q, db, device=CPU, **kw)[0]


def _runner(db, **kw):
    return progressive.ProgressiveRunner(db, device=CPU, **kw)


def _equal(got, want, label):
    """Integers exactly, floats within rtol 1e-7, same columns."""
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want), label
    for k in want:
        assert got[k].shape == want[k].shape, (label, k)
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-7,
                                       err_msg=f"{label} {k}")
        else:
            assert np.array_equal(got[k], want[k]), (label, k)


# ---------------------------------------------------------------------------
# sampling invariants
# ---------------------------------------------------------------------------

def test_selection_rates_and_min_one():
    rng = np.random.default_rng(APPROX_SEED)
    g = rng.integers(0, 12, size=3000).astype(np.int64)
    for den in DENS:
        mask, sid, n_g, m_g = sampling.stratified_selection([g], g.size, den)
        np.testing.assert_array_equal(m_g, np.maximum(1, -(-n_g // den)))
        got = np.bincount(sid[mask], minlength=n_g.size)
        np.testing.assert_array_equal(got, m_g)
    tiny = np.array([0, 1, 1, 1, 1], dtype=np.int64)
    mask, _, n_g, m_g = sampling.stratified_selection([tiny], 5, 16)
    assert m_g[0] == 1 and mask[0]


def test_rungs_nest():
    rng = np.random.default_rng(APPROX_SEED + 1)
    g = rng.integers(0, 7, size=2000).astype(np.int64)
    masks = {den: sampling.stratified_selection([g], g.size, den)[0]
             for den in (16, 8, 4, 2, 1)}
    assert masks[1].all()
    for small, big in ((16, 8), (8, 4), (4, 2), (2, 1)):
        assert not np.any(masks[small] & ~masks[big])


def test_selection_deterministic_in_seed():
    g = np.zeros(1000, dtype=np.int64)
    a = sampling.stratified_selection([g], 1000, 4, seed=7)[0]
    b = sampling.stratified_selection([g], 1000, 4, seed=7)[0]
    c = sampling.stratified_selection([g], 1000, 4, seed=8)[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="denominator"):
        sampling.stratified_selection([g], 1000, 0)


def test_sample_table_bookkeeping():
    rng = np.random.default_rng(APPROX_SEED + 2)
    g = rng.integers(0, 9, size=1500).astype(np.int64)
    cols = {"g": g, "v": rng.normal(size=g.size)}
    s = sampling.sample_table(cols, ("g",), 4)
    n_g = np.bincount(g)
    m_g = np.maximum(1, -(-n_g // 4))
    np.testing.assert_array_equal(s["__sn"], n_g[s["g"]])
    np.testing.assert_array_equal(s["__sm"], m_g[s["g"]])
    np.testing.assert_allclose(s["__sw"], n_g[s["g"]] / m_g[s["g"]], rtol=0)
    assert s["__sw"].dtype == np.float64
    mask = sampling.stratified_selection([g], g.size, 4)[0]
    np.testing.assert_array_equal(s["v"], cols["v"][mask])
    with pytest.raises(KeyError):
        sampling.sample_table(cols, ("h",), 4)
    with pytest.raises(TypeError):
        sampling.sample_table(cols, ("v",), 4)


def test_sample_table_empty_strata():
    cols = {"g": np.zeros(0, dtype=np.int64), "v": np.zeros(0)}
    s = sampling.sample_table(cols, ("g",), 8)
    assert s["g"].size == 0 and s["__sw"].size == 0


def test_rung_database_cached_and_invalidated():
    rng = np.random.default_rng(APPROX_SEED + 3)
    db2 = Database(tables={"facts": {
        "g": rng.integers(0, 5, 400).astype(np.int64),
        "v": rng.normal(size=400)}}, dicts={}, scale=1.0)
    r1 = sampling.rung_database(db2, "facts", ("g",), 4)
    assert sampling.rung_database(db2, "facts", ("g",), 4) is r1
    assert sampling.rung_name("facts", 4) in r1.tables
    assert B.PARTITION_KEYS.get(sampling.rung_name("facts", 4)) == \
        B.PARTITION_KEYS.get("facts")
    planner.invalidate_stats(db2)
    assert sampling.rung_database(db2, "facts", ("g",), 4) is not r1
    sampling.invalidate(db2)


@pytest.mark.parametrize("order", [(16, 8, 4, 2, 1), (1, 2, 16, 4, 8)])
def test_ladder_shares_its_rank_and_equals_the_reference(order):
    """A ladder's rungs share the strata numbering and the hash rank
    (rung 1 needs no rank); built in any order, each rung's sample is the
    reference's ``sample_table`` byte for byte, and the rank goes with
    the rungs."""
    rng = np.random.default_rng(APPROX_SEED + 5)
    cols = {"g": rng.integers(0, 7, 3000).astype(np.int64),
            "h": rng.integers(0, 3, 3000).astype(np.int32),
            "v": rng.normal(size=3000)}
    db2 = Database(tables={"facts": cols}, dicts={}, scale=1.0)
    try:
        for den in order:
            got = sampling.rung_database(db2, "facts", ("g", "h"), den)
            want = rsampling.sample_table(cols, ("g", "h"), den)
            samp = got.tables[sampling.rung_name("facts", den)]
            assert set(samp) == set(want)
            for c in want:
                assert samp[c].dtype == want[c].dtype
                assert samp[c].tobytes() == want[c].tobytes(), (den, c)
        assert any(k[0] == id(db2) for k in sampling._RANKS)
        planner.invalidate_stats(db2)
        assert not any(k[0] == id(db2) for k in sampling._RANKS)
    finally:
        sampling.invalidate(db2)


def test_rung_partition_key_hygiene():
    rng = np.random.default_rng(APPROX_SEED + 4)
    db2 = Database(tables={"facts": {
        "g": rng.integers(0, 5, 400).astype(np.int64),
        "v": rng.normal(size=400)}}, dicts={}, scale=1.0)
    name = sampling.rung_name("facts", 8)
    try:
        sampling.rung_database(db2, "facts", ("g",), 8)
        assert name not in B.PARTITION_KEYS
        sampling.invalidate(db2)
        B.PARTITION_KEYS["facts"] = "g"
        sampling.rung_database(db2, "facts", ("g",), 8)
        assert B.PARTITION_KEYS[name] == "g"
        planner.invalidate_stats(db2)
        assert name not in B.PARTITION_KEYS
    finally:
        B.PARTITION_KEYS.pop("facts", None)
        B.PARTITION_KEYS.pop(name, None)
        sampling.invalidate(db2)


def test_invalidate_all_drops_every_rung_and_its_device_tables():
    rng = np.random.default_rng(APPROX_SEED + 5)
    db2 = Database(tables={"facts": {
        "g": rng.integers(0, 5, 400).astype(np.int64),
        "v": rng.normal(size=400)}}, dicts={}, scale=1.0)
    r = sampling.rung_database(db2, "facts", ("g",), 2)
    B.device_tables(r, torch.device(CPU))
    sampling.invalidate()
    assert "_device_tables" not in r.__dict__
    assert sampling.rung_database(db2, "facts", ("g",), 2) is not r
    sampling.invalidate(db2)


# ---------------------------------------------------------------------------
# sampling against the reference, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("den", (16, 8, 4, 2, 1))
@pytest.mark.parametrize("strata", [
    (), ("l_returnflag", "l_linestatus"),   # one stratum; Q1's 4 strata
    ("l_suppkey",),                          # 50 strata at sf 0.005
    ("l_partkey",),                          # one wide key
    ("l_orderkey", "l_partkey")])            # a stratum per row or so
def test_sample_table_equals_the_reference(db, rdb, den, strata):
    li, rli = db.tables["lineitem"], rdb.tables["lineitem"]
    got = sampling.sample_table(li, strata, den)
    want = rsampling.sample_table(rli, strata, den)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    n = len(li["l_orderkey"])
    sel = [li[s] for s in strata]
    for a, b in zip(sampling.stratified_selection(sel, n, den, seed=99),
                    rsampling.stratified_selection(
                        [rli[s] for s in strata], n, den, seed=99)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape", [(5000, 1, 3), (5000, 2, 40),
                                   (5000, 3, 1 << 12), (300, 2, 1 << 40)])
def test_stratum_ids_are_the_unique_rows_inverse(shape):
    n, k, span = shape
    rng = np.random.default_rng(APPROX_SEED + 7)
    cols = [rng.integers(-span // 2, span, n) for _ in range(k)]
    _, want = np.unique(np.stack(cols, axis=1), axis=0, return_inverse=True)
    got = sampling._stratum_ids(cols, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.reshape(-1))


def test_ladder_and_names_equal_the_reference():
    assert sampling.LADDER == rsampling.LADDER
    assert sampling.DEFAULT_SEED == rsampling.DEFAULT_SEED
    assert sampling.rung_name("lineitem", 8) == \
        rsampling.rung_name("lineitem", 8)


# ---------------------------------------------------------------------------
# estimator unit behavior, and its numbers against the reference's
# ---------------------------------------------------------------------------

def test_t_value_table_and_normal_limit():
    assert float(estimators.t_value(1)) == pytest.approx(12.706)
    assert float(estimators.t_value(10)) == pytest.approx(2.228)
    assert float(estimators.t_value(31)) == pytest.approx(
        estimators.z_value(0.95))
    df = np.array([1, 2, 5, 30, 100])
    assert np.all(np.diff(estimators.t_value(df)) < 0)


def test_z_value_bisection_fallback():
    assert estimators.z_value(0.975) == pytest.approx(2.241402728, abs=1e-6)


@pytest.mark.parametrize("confidence", [0.90, 0.95, 0.99, 0.975, 0.8])
def test_critical_values_equal_the_reference(confidence):
    assert estimators.z_value(confidence) == \
        restimators.z_value(confidence)
    df = np.arange(0, 40)
    assert estimators.t_value(df, confidence).tobytes() == \
        restimators.t_value(df, confidence).tobytes()


@pytest.mark.parametrize("op", sorted(estimators.ESTIMABLE_OPS))
def test_interval_equals_the_reference(op):
    rng = np.random.default_rng(APPROX_SEED + 6)
    n = rng.integers(1, 500, 64)
    m = np.minimum(n, rng.integers(1, 40, 64))
    mf = rng.integers(0, 41, 64) % (m + 1)
    s1 = rng.gamma(2.0, 10.0, 64) * mf
    s2 = s1 * s1 / np.maximum(mf, 1) + rng.gamma(2.0, 5.0, 64)
    for conf in (0.9, 0.95, 0.975):
        got = estimators.interval(op, n, m, mf, s1, s2, conf)
        want = restimators.interval(op, n, m, mf, s1, s2, conf)
        for a, b in zip(got, want):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_interval_honesty_gates():
    _, hw = estimators.interval("sum", n=100, m=1, mf=1, s1=5.0, s2=25.0)
    assert np.isinf(hw)
    _, hw = estimators.interval("sum", n=10, m=10, mf=4, s1=5.0, s2=25.0)
    assert float(hw) == 0.0
    _, hw = estimators.interval("avg", n=100, m=8, mf=1, s1=5.0, s2=25.0)
    assert np.isinf(hw)


def test_non_estimable_ops_raise():
    with pytest.raises(ValueError):
        estimators.interval("min", 10, 5, 5, 1.0, 1.0)
    with pytest.raises(ValueError):
        estimators.point_estimate("max", 10, 5, 5, 1.0)


def test_finalize_raises_on_dropped_moments():
    with pytest.raises(ValueError, match="moment"):
        estimators.finalize_result({"s": np.array([7.0])},
                                   (("s", "sum"),), scaled=True)
    with pytest.raises(ValueError, match="s1"):
        estimators.finalize_result(
            {"s": np.array([7.0]),
             estimators.N_COL: np.array([16]),
             estimators.M_COL: np.array([4]),
             estimators.MF_COL: np.array([4])},
            (("s", "sum"),), scaled=True)
    est = estimators.finalize_result({"s": np.array([7.0])},
                                     (("s", "sum"),), scaled=False)
    assert est.exact and est.rel_width == 0.0


# ---------------------------------------------------------------------------
# Monte-Carlo coverage: the statistical gate, and the reference's rates
# ---------------------------------------------------------------------------

def _scalar_coverage(mod_e, mod_s, op, den, trials, seed) -> float:
    """Empirical CI coverage for one op x rung on random skewed populations
    (the reference's harness, run on the given package's modules)."""
    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(trials):
        n = int(rng.integers(400, 2000))
        v = rng.gamma(2.0, 10.0, size=n)
        keep = v > np.quantile(v, rng.uniform(0.2, 0.6))
        mask, _, _, m_g = mod_s.stratified_selection(
            [], n, den, seed=int(rng.integers(1 << 31)))
        m = int(m_g[0])
        sv, sk = v[mask], keep[mask]
        mf = int(sk.sum())
        if op == "avg":
            xs = sv[sk]
            s1, s2 = float(xs.sum()), float((xs * xs).sum())
            truth = float(v[keep].mean()) if keep.any() else np.nan
        else:
            x = np.where(sk, sv, 0.0)
            s1, s2 = float(x.sum()), float((x * x).sum())
            truth = float(v[keep].sum()) if op == "sum" else float(keep.sum())
        est, hw = mod_e.interval(op, n, m, mf, s1, s2)
        if np.isinf(float(hw)) or (truth == truth and
                                   abs(truth - float(est)) <= float(hw)):
            hits += 1
    return hits / trials


@pytest.mark.parametrize("op", sorted(estimators.ESTIMABLE_OPS))
@pytest.mark.parametrize("den", DENS)
def test_coverage_smoke(op, den, approx_seed):
    cov = _scalar_coverage(estimators, sampling, op, den, SMOKE_TRIALS,
                           approx_seed + den)
    assert cov >= 0.80, f"{op} 1/{den}: coverage {cov}"
    assert cov == _scalar_coverage(restimators, rsampling, op, den,
                                   SMOKE_TRIALS, approx_seed + den)


@pytest.mark.parametrize("op", sorted(estimators.ESTIMABLE_OPS))
@pytest.mark.parametrize("den", DENS)
def test_coverage_full(op, den, approx_seed):
    """The reference's 200-trial gate, and its rate exactly."""
    cov = _scalar_coverage(estimators, sampling, op, den, FULL_TRIALS,
                           approx_seed + den)
    assert cov >= 0.90, f"{op} 1/{den}: coverage {cov}"
    assert cov == _scalar_coverage(restimators, rsampling, op, den,
                                   FULL_TRIALS, approx_seed + den)


def _group_coverage(mod_e, mod_s, op, den, trials, seed) -> float:
    rng = np.random.default_rng(seed)
    hits = total = 0
    for _ in range(trials):
        sizes = rng.integers(4, 400, size=10)
        g = np.repeat(np.arange(10), sizes)
        v = rng.gamma(2.0, 10.0, size=g.size)
        samp = mod_s.sample_table(
            {"g": g.astype(np.int64), "v": v}, ("g",), den,
            seed=int(rng.integers(1 << 31)))
        thr = np.quantile(v, 0.3)
        for gi in range(10):
            gm = samp["g"] == gi
            n, m = int(samp["__sn"][gm][0]), int(samp["__sm"][gm][0])
            sv = samp["v"][gm]
            sk = sv > thr
            mf = int(sk.sum())
            pop = v[g == gi]
            popk = pop > thr
            if op == "avg":
                xs = sv[sk]
                s1, s2 = float(xs.sum()), float((xs * xs).sum())
                truth = float(pop[popk].mean()) if popk.any() else np.nan
            else:
                x = np.where(sk, sv, 0.0)
                s1, s2 = float(x.sum()), float((x * x).sum())
                truth = (float(pop[popk].sum()) if op == "sum"
                         else float(popk.sum()))
            est, hw = mod_e.interval(op, n, m, mf, s1, s2)
            total += 1
            if np.isinf(float(hw)) or (truth == truth and
                                       abs(truth - float(est)) <= float(hw)):
                hits += 1
    return hits / total


@pytest.mark.parametrize("op", sorted(estimators.ESTIMABLE_OPS))
@pytest.mark.parametrize("den", DENS)
def test_group_coverage(op, den, approx_seed):
    seed = (approx_seed + den) ^ 0xABCDEF
    cov = _group_coverage(estimators, sampling, op, den, SMOKE_TRIALS, seed)
    assert cov >= 0.85, f"{op} 1/{den}: group coverage {cov}"
    assert cov == _group_coverage(restimators, rsampling, op, den,
                                  SMOKE_TRIALS, seed)


def test_plan_level_coverage_q1(db, approx_seed):
    """The rewritten q1 plan's per-group error bars cover the exact answers
    across 10 sampling seeds at rung 1/8 (>= 90 %), on the port's engine."""
    exact = _local(QUERIES[1], db)
    keys = ("l_returnflag", "l_linestatus")
    exact_by_key = {tuple(int(exact[k][i]) for k in keys): i
                    for i in range(exact[keys[0]].size)}
    hits = total = 0
    for s in range(10):
        rw = rewrite_for_rung(QUERIES[1], db, 8, seed=approx_seed + s)
        est = rw.finalize(_local(rw.query, rw.db))
        for name, _op in rw.targets:
            hw = est.half_width[name]
            for i in range(est.result[keys[0]].size):
                j = exact_by_key[tuple(int(est.result[k][i]) for k in keys)]
                total += 1
                if np.isinf(hw[i]) or \
                        abs(float(exact[name][j]) -
                            float(est.result[name][i])) <= float(hw[i]):
                    hits += 1
    assert total >= 10 * 4 * len(rw.targets) // 2
    assert hits / total >= 0.90, f"plan-level coverage {hits / total}"


# ---------------------------------------------------------------------------
# rewrites against the reference: signatures, refusals, estimates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("den", (16, 8, 4, 2, 1))
def test_rewrites_equal_the_reference(db, rdb, den):
    """Every template and hand-built query: refused exactly where the
    reference refuses, else the reference's plan signature, sampled table,
    strata and targets."""
    from repro.serve import TEMPLATES as RTEMPLATES
    pairs = [(TEMPLATES[q].query, RTEMPLATES[q].query) for q in TEMPLATES] \
        + [(QUERIES[q], RQUERIES[q]) for q in QUERIES]
    for q, rq in pairs:
        rw = rewrite_for_rung(q, db, den)
        rrw = rrewrite.rewrite_for_rung(rq, rdb, den)
        assert (rw is None) == (rrw is None), q.name
        if rw is None:
            continue
        assert rw.query.signature() == RPL.plan_signature(rrw.query.plan)
        assert (rw.table, rw.strata, rw.targets, rw.den) == \
            (rrw.table, rrw.strata, rrw.targets, rrw.den), q.name
        assert rw.query.name == rrw.query.name


@pytest.mark.parametrize("qid", [1, 6])
@pytest.mark.parametrize("den", DENS)
def test_rung_estimates_equal_the_reference(db, rdb, qid, den):
    rw = rewrite_for_rung(QUERIES[qid], db, den)
    rrw = rrewrite.rewrite_for_rung(RQUERIES[qid], rdb, den)
    got = rw.finalize(_local(rw.query, rw.db))
    want = rrw.finalize(RB.run_local(rrw.query, rrw.db, jit=False)[0])
    _equal(got.result, want.result, f"q{qid} 1/{den}")
    assert got.rel_width == pytest.approx(want.rel_width, rel=1e-7)
    assert 0.0 < got.rel_width < np.inf


@pytest.mark.parametrize("wire", [None, "wide"])
@pytest.mark.parametrize("infer", [True, False])
@pytest.mark.parametrize("qid", [1, 6, 18])
def test_rung1_byte_identity(db, qid, infer, wire):
    """den == 1 is a pure scan rename: byte-identical to the exact plan on
    both planner legs and both wire formats."""
    rw = rewrite_for_rung(QUERIES[qid], db, 1)
    assert rw is not None and rw.den == 1
    exact = _local(QUERIES[qid].with_inference(infer), db, wire_format=wire)
    got = _local(rw.query.with_inference(infer), rw.db, wire_format=wire)
    assert set(exact) == set(got)
    for k in exact:
        assert got[k].dtype == exact[k].dtype
        assert got[k].tobytes() == exact[k].tobytes(), k
    assert rw.finalize(got).exact


def test_approximate_is_the_rewrite(db):
    rw = QUERIES[6].approximate(db, 4)
    assert rw is not None and rw.den == 4
    assert rw.query.signature() == \
        rewrite_for_rung(QUERIES[6], db, 4).query.signature()
    assert QUERIES[4].approximate(db, 4) is None
    assert QUERIES[6].approximate(db, 4, min_rows=10 ** 9) is None


def _synth_db(rows=512, groups=8, seed=0):
    rng = np.random.default_rng(APPROX_SEED + seed)
    return Database(tables={"facts": {
        "g": rng.integers(0, groups, rows).astype(np.int64),
        "v": rng.normal(size=rows)}}, dicts={}, scale=1.0)


def test_refuses_min_max(db):
    db2 = _synth_db()
    q = planner.compile_query(lambda: scan("facts").group_by(
        ["g"], [("mx", "max", "v")], exchange="gather", final=True),
        name="minmax")
    assert rewrite_for_rung(q, db2, 4, tables=("facts",)) is None
    assert rewrite_for_rung(QUERIES[2], db, 4) is None


def test_refuses_semi_join_counts(db):
    assert rewrite_for_rung(QUERIES[4], db, 4) is None


def test_refuses_tiny_table():
    db2 = _synth_db(rows=100)
    q = planner.compile_query(lambda: scan("facts").group_by(
        ["g"], [("s", "sum", "v")], exchange="gather", final=True),
        name="tiny")
    assert rewrite_for_rung(q, db2, 4, tables=("facts",)) is None
    assert rewrite_for_rung(q, db2, 4, tables=("facts",),
                            min_rows=10) is not None


def test_refuses_group_estimate_feeding_computation(db):
    for den in (16, 8, 4, 2):
        assert rewrite_for_rung(QUERIES[18], db, den) is None
        assert rewrite_for_rung(TEMPLATES[18].query, db, den) is None
    db2 = _synth_db()
    q = planner.compile_query(lambda: scan("facts").group_by(
        ["g"], [("s", "sum", "v")], exchange="gather", final=True)
        .filter(col("s") > 0.0).finalize(replicated=True), name="having")
    assert rewrite_for_rung(q, db2, 4, tables=("facts",)) is None
    from repro_torch.sql import compile_sql
    qs = compile_sql("SELECT l_returnflag, sum(l_quantity) AS sq "
                     "FROM lineitem GROUP BY l_returnflag "
                     "HAVING sum(l_quantity) > 100", name="having_sql")
    assert rewrite_for_rung(qs, db, 4) is None


def test_select_above_site_keeps_moments(db):
    from repro_torch.sql import compile_sql
    q = compile_sql("SELECT sum(l_quantity) AS sq, l_returnflag "
                    "FROM lineitem GROUP BY l_returnflag "
                    "ORDER BY l_returnflag", name="reorder")
    for den in (16, 4):
        rw = rewrite_for_rung(q, db, den)
        assert rw is not None
        cols = _local(rw.query, rw.db)
        assert estimators.N_COL in cols
        est = rw.finalize(cols)
        assert 0.0 < est.rel_width < np.inf
        assert estimators.N_COL not in est.result
    db2 = _synth_db(rows=2048)
    qp = planner.compile_query(lambda: scan("facts").group_by(
        ["g"], [("s", "sum", "v"), ("c", "count", None)],
        exchange="gather", final=True).select("s", "g")
        .finalize(sort_keys=[("g", True)], replicated=True), name="proj")
    rw = rewrite_for_rung(qp, db2, 4, tables=("facts",))
    est = rw.finalize(_local(rw.query, rw.db))
    assert "c" not in est.result and "s" in est.half_width
    assert est.rel_width > 0.0


def test_refuses_estimate_in_scalar_arithmetic():
    db2 = _synth_db()
    base = scan("facts")
    agg = base.agg_scalar([("s", "sum", "v"), ("c", "count", None)])
    q = planner.compile_query(
        lambda: P.ScalarResult({"ratio": P.ScalarRef(agg, "s") /
                                P.ScalarRef(agg, "c")}), name="ratio")
    assert rewrite_for_rung(q, db2, 4, tables=("facts",)) is None


def test_progressive_rejects_off_ladder_rung(db):
    with pytest.raises(ValueError, match="sampling ladder"):
        _runner(db, ladder=(32, 16, 1))
    with pytest.raises(ValueError, match="end at rung 1"):
        _runner(db, ladder=(16, 4))
    with pytest.raises(ValueError, match="tolerance"):
        _runner(db, tolerance=-1.0)
    assert _runner(db, ladder=(16, 4, 1)).ladder == (16, 4, 1)


def test_progressive_runs_on_cuda_unless_told(db, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        progressive.ProgressiveRunner(db)


def test_progressive_exact_fallback(db):
    ans = _runner(db, tolerance=0.5).run(QUERIES[4])
    assert ans.rung == 0 and ans.exact and ans.ci_width == 0.0
    exact, _ = B.run_reference(QUERIES[4], db)
    for k in exact:
        np.testing.assert_array_equal(np.asarray(ans.result[k]),
                                      np.asarray(exact[k]))
    assert ans.report.attempts[-1].rung == 0


# ---------------------------------------------------------------------------
# progressive escalation
# ---------------------------------------------------------------------------

def test_absent_group_escalates_never_fabricates(db):
    rng = np.random.default_rng(APPROX_SEED + 9)
    g = np.repeat(np.arange(8), 64).astype(np.int64)
    v = np.tile(np.arange(64), 8).astype(np.int64)
    perm = rng.permutation(g.size)
    db2 = Database(tables={"facts": {"g": g[perm], "v": v[perm]}},
                   dicts={}, scale=1.0)

    def build():
        return scan("facts").filter(col("v") > 62).group_by(
            ["g"], [("c", "count", None), ("s", "sum", "v")],
            exchange="gather", final=True) \
            .finalize(sort_keys=[("g", True)], replicated=True)

    q = planner.compile_query(build, name="needle")
    rw = rewrite_for_rung(q, db2, 4, tables=("facts",))
    cols = _local(rw.query, rw.db)
    assert cols["g"].size <= 8
    assert np.all(np.asarray(cols["c"], np.float64) > 0)
    assert np.all(np.asarray(cols["s"], np.float64) > 0)
    ans = _runner(db2, tolerance=0.05, tables=("facts",)).run(q)
    assert ans.rung == 1 and ans.exact
    np.testing.assert_array_equal(ans.result["g"], np.arange(8))
    np.testing.assert_array_equal(np.asarray(ans.result["c"], np.int64),
                                  np.ones(8, np.int64))
    np.testing.assert_array_equal(np.asarray(ans.result["s"], np.int64),
                                  np.full(8, 63))
    assert ans.escalations == len(ans.report.attempts) - 1


def test_progressive_termination_property(db):
    """For any tolerance the runner terminates with a final interval within
    tolerance or the exact top rung; every climb is an audited
    TOLERANCE_MISS whose measured width exceeded the tolerance (the
    reference's seeded log-uniform sweep; hypothesis where installed)."""
    def prop(tol):
        ans = _runner(db, tolerance=tol).run(QUERIES[6])
        rungs = [a.rung for a in ans.report.attempts]
        assert rungs == sorted(rungs, reverse=True)
        assert ans.rung >= 1
        assert ans.ci_width <= tol or ans.rung == 1
        for a in ans.report.attempts[:-1]:
            assert a.outcome == "tolerance_miss"
            assert a.ci_width > tol
        assert ans.report.attempts[-1].outcome == "ok"
        assert ans.escalations == len(ans.report.attempts) - 1

    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:
        rng = np.random.default_rng(APPROX_SEED)
        for tol in 10.0 ** rng.uniform(-4.0, 1.0, size=6):
            prop(float(tol))
        return
    settings(max_examples=8, deadline=None, derandomize=True)(
        given(tol=st.floats(min_value=1e-4, max_value=10.0,
                            allow_nan=False, allow_infinity=False))(prop))()


def test_progressive_rung1_is_exact(db):
    ans = _runner(db, tolerance=0.0).run(QUERIES[6])
    assert ans.rung == 1 and ans.exact and ans.ci_width == 0.0
    exact, _ = B.run_reference(QUERIES[6], db)
    np.testing.assert_array_equal(np.asarray(ans.result["revenue"]),
                                  np.asarray(exact["revenue"]))
    assert [a.rung for a in ans.report.attempts] == [16, 8, 4, 2, 1]


@pytest.mark.parametrize("tol", [0.3, 0.02, 0.0])
@pytest.mark.parametrize("qid", [1, 6])
def test_progressive_answers_equal_the_reference(db, rdb, qid, tol):
    ans = _runner(db, tolerance=tol).run(QUERIES[qid])
    rans = rprogressive.ProgressiveRunner(rdb, tolerance=tol,
                                          local_jit=False).run(RQUERIES[qid])
    assert (ans.rung, ans.escalations, ans.exact) == \
        (rans.rung, rans.escalations, rans.exact)
    assert ans.ci_width == pytest.approx(rans.ci_width, rel=1e-7)
    _equal(ans.result, rans.result, f"q{qid} tol {tol}")
    assert [(a.rung, a.outcome) for a in ans.report.attempts] == \
        [(a.rung, a.outcome) for a in rans.report.attempts]


def test_progressive_on_a_thread_group_equals_local(db):
    """Rungs executed distributed (2 ranks): the sample partitions on the
    base table's key and the moments ride the exchanges, so the answer and
    its error bar equal the single-device run's."""
    for qid in (1, 6):
        got = _runner(db, group=2, tolerance=0.0).run(QUERIES[qid])
        want = _runner(db, tolerance=0.0).run(QUERIES[qid])
        assert [a.ci_width for a in got.report.attempts] == pytest.approx(
            [a.ci_width for a in want.report.attempts], rel=1e-7)
        _equal(got.result, want.result, f"q{qid}")
        assert all(a.devices == 2 for a in got.report.attempts)


def _supplier_revenue():
    from repro_torch.core.table import days
    return scan("lineitem").filter(col("l_shipdate") <= days("1998-09-02")) \
        .group_by(["l_suppkey"],
                  [("revenue", "sum",
                    col("l_extendedprice") * (1 - col("l_discount"))),
                   ("n", "count", None)], exchange="shuffle") \
        .finalize(sort_keys=[("l_suppkey", True)])


@pytest.mark.parametrize("den", DENS)
def test_moments_ride_a_shuffle(db, den):
    """A site whose group-by shuffles: the rung shards on the base table's
    key, the moment columns merge across the exchange, and each estimate
    and its error bar equal the single-device rung's."""
    q = planner.compile_query(_supplier_revenue, name="supplier_revenue")
    rw = rewrite_for_rung(q, db, den)
    assert rw.strata == ("l_suppkey",)
    one = rw.finalize(_local(rw.query, rw.db))
    got, stats, overflow = B.run_distributed(rw.query, rw.db, 3, device=CPU)
    assert not overflow and stats.counts()["shuffles"] == 1
    dist = rw.finalize(got)
    _equal(dist.result, one.result, f"1/{den}")
    assert dist.rel_width == pytest.approx(one.rel_width, rel=1e-7)
    assert 0.0 < one.rel_width < np.inf


# ---------------------------------------------------------------------------
# surfacing: audit table + serving
# ---------------------------------------------------------------------------

def test_run_report_renders_rung_and_ci(db, capsys):
    from repro_torch.launch import report as rep
    ans = _runner(db, tolerance=0.0).run(QUERIES[6])
    rec = json.loads(json.dumps(rep.run_report_record("q6", ans.report)))
    fallback = _runner(db, tolerance=0.5).run(QUERIES[4])
    rec2 = json.loads(json.dumps(rep.run_report_record("q4",
                                                       fallback.report)))
    rep.run_report_table([rec, rec2])
    out = capsys.readouterr().out
    assert "| rung | ci |" in out
    for den in (16, 8, 4, 2):
        assert f"| 1/{den} |" in out
    assert "| 1/1 | 0.00% |" in out
    assert "| exact |" in out
    miss = [ln for ln in out.splitlines() if "tolerance_miss" in ln]
    assert len(miss) == 4 and all("%" in ln for ln in miss)


def test_run_report_table_equals_the_reference(db, rdb, capsys):
    from repro.launch import report as rrep
    from repro_torch.launch import report as rep
    ans = _runner(db, tolerance=0.0).run(QUERIES[1])
    rans = rprogressive.ProgressiveRunner(
        rdb, tolerance=0.0, local_jit=False).run(RQUERIES[1])
    rec = rep.run_report_record("q1", ans.report)
    rrec = rrep.run_report_record("q1", rans.report)
    for r in (rec, rrec):
        for a in r["attempts"]:
            a["wall_s"] = a["backoff_s"] = 0.0
    rep.run_report_table([rec])
    got = capsys.readouterr().out
    rrep.run_report_table([rrec])
    assert got == capsys.readouterr().out
    assert rep.fmt_bytes(3 * 1024 ** 3) == rrep.fmt_bytes(3 * 1024 ** 3)
    assert rep._fmt_ci(float("inf")) == "inf" and rep._fmt_ci(None) == "-"


def test_serve_tolerance_path(db):
    from repro_torch import serve
    srv = serve.QueryServer(db, device=CPU)
    r = srv.submit(6, tolerance=0.5)
    assert srv.approx_served == 1 and srv.approx_escalations == 0
    assert r["revenue"].size == 1
    rc0, h0 = srv.recompiles, srv.cache_hits
    srv.submit(6, tolerance=0.5)
    assert srv.recompiles == rc0 and srv.cache_hits >= h0 + 2
    approx = srv.submit(6, tolerance=0.0)
    exact = srv.submit(6)
    assert set(approx) == set(exact)
    for k in exact:
        assert approx[k].tobytes() == exact[k].tobytes()
    assert srv.approx_escalations == 4
    r4 = srv.submit(4, tolerance=0.5)
    assert srv.approx_refused == 1
    exact4, _ = B.run_reference(QUERIES[4], db)
    np.testing.assert_array_equal(np.asarray(r4["order_count"]),
                                  np.asarray(exact4["order_count"]))


@pytest.mark.parametrize("qid", [1, 6, 18])
def test_serve_tolerance_equals_the_reference(db, rdb, qid):
    from repro import serve as rserve
    from repro_torch import serve
    srv, rsrv = serve.QueryServer(db, device=CPU), rserve.QueryServer(rdb)
    for tol in (0.5, 0.01):
        got = srv.submit(qid, tolerance=tol)
        want = rsrv.submit(qid, tolerance=tol)
        _equal(got, want, f"q{qid} tol {tol}")
    assert (srv.approx_served, srv.approx_escalations, srv.approx_refused,
            srv.recompiles) == \
        (rsrv.approx_served, rsrv.approx_escalations, rsrv.approx_refused,
         rsrv.recompiles)


def test_approx_default_env(monkeypatch):
    monkeypatch.delenv("REPRO_APPROX", raising=False)
    assert progressive.approx_default() is None
    monkeypatch.setenv("REPRO_APPROX", "off")
    assert progressive.approx_default() is None
    monkeypatch.setenv("REPRO_APPROX", "0.25")
    assert progressive.approx_default() == 0.25


def test_serve_env_default_tolerance(db, monkeypatch):
    from repro_torch import serve
    monkeypatch.setenv("REPRO_APPROX", "0.5")
    srv = serve.QueryServer(db, device=CPU)
    srv.submit(6)
    assert srv.approx_served == 1
