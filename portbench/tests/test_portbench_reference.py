"""The reference against the program, and the comparison itself.

The reference (``portbench/reference``) answers every template and binding
of both traffic mixes, on the data of two seeds, as
``QueryServer(device="cpu")`` does; the comparison tolerates what SQL leaves
open (the order of rows the ORDER BY ties) and nothing else.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import loadgen  # noqa: E402
from portbench.compare import compare  # noqa: E402
from portbench.data import device_tpch  # noqa: E402
from portbench.reference import tpch as R  # noqa: E402
from repro_torch.core.table import Database  # noqa: E402
from repro_torch.serve import QueryServer  # noqa: E402

CONFIG = "tpch-sf30"
MIXES = ["power", "q1q6"]
SF = 0.01
SEEDS = [2**31 + 21, 97]


def _json(*parts):
    return json.loads(ROOT.joinpath("portbench", *parts).read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers at once, and each torch would otherwise start a thread a
    core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=SEEDS, ids=["seed_a", "seed_b"])
def served(request):
    seed = request.param
    cfg = _json("configs", f"{CONFIG}.json")
    tables, dicts = device_tpch.generate(SF, seed, device="cpu")
    server = QueryServer(Database(tables, dicts, SF), device="cpu")
    ref = R.RefDB(tables, dicts, SF, "cpu", torch.float64)
    return seed, cfg, server, ref


@pytest.mark.parametrize("mix", MIXES)
def test_reference_equals_the_server(served, mix):
    seed, cfg, server, ref = served
    reqs = loadgen.cycle(_json("traffic", f"{mix}.json"), seed)
    keys = {r.key: r for r in reqs}
    assert len(keys) == {"power": 30, "q1q6": 6}[mix]
    for r in keys.values():
        got = server.submit(r.qid, dict(r.binding))
        want = R.answer(ref, r.qid, r.binding)
        wrong, gap = compare(got, want, R.ORDER[r.qid], cfg["limits"]["gap"])
        assert wrong == 0, r
        assert gap <= cfg["limits"]["gap"], (r, gap)


def test_bindings_follow_the_specifications_rules():
    mix = _json("traffic", "power.json")
    for seed in (1, 2**31 + 5, 7 * 2**40):
        b = loadgen.bindings(mix, seed)
        assert len(b[1]) == len(b[6]) == 3 and b[14] == [{}]
        for x in b[1]:
            assert R.days("1998-08-03") <= x["q1_cutoff"] <= \
                R.days("1998-10-01")
        for x in b[3]:
            assert R.days("1995-03-01") <= x["q3_date"] <= \
                R.days("1995-03-31")
        for x in b[6]:
            assert x["q6_disc_hi"] - x["q6_disc_lo"] == pytest.approx(0.02)
            assert 0.01 <= x["q6_disc_lo"] <= 0.07
            assert x["q6_qty"] in (24, 25)
            assert x["q6_date_hi"] - x["q6_date_lo"] in (365, 366)
        for x in b[5]:
            assert x["q5_date_hi"] - x["q5_date_lo"] in (365, 366)
    # q1q6 sends Q1 and Q6 the bindings the power mix sends them
    q = loadgen.bindings(_json("traffic", "q1q6.json"), 9)
    p = loadgen.bindings(mix, 9)
    assert q[1] == p[1] and q[6] == p[6]


def test_cycle_cycles_bindings_in_the_mixs_order():
    mix = _json("traffic", "power.json")
    reqs = loadgen.cycle(mix, 3)
    assert len(reqs) == 66
    assert [r.qid for r in reqs[:22]] == mix["order"]
    assert [r.key for r in reqs if r.qid == 1] == ["q1.0", "q1.1", "q1.2"]
    assert [r.key for r in reqs if r.qid == 9] == ["q9.0"] * 3


def _t(**cols):
    return {k: np.asarray(v) for k, v in cols.items()}


def test_compare_takes_tied_rows_in_either_order():
    ref = _t(k=[1, 2, 3], v=[5.0, 5.0, 4.0])
    got = _t(k=[2, 1, 3], v=[5.0, 5.0, 4.0])
    assert compare(got, ref, [("v", False)], 1e-9) == (0, 0.0)


def test_compare_counts_order_breaks_missing_rows_and_wrong_keys():
    ref = _t(k=[1, 2, 3], v=[6.0, 5.0, 4.0])
    assert compare(_t(k=[2, 1, 3], v=[5.0, 6.0, 4.0]), ref,
                   [("v", False)], 1e-9)[0] == 1
    assert compare(_t(k=[1, 2], v=[6.0, 5.0]), ref, [("v", False)],
                   1e-9)[0] == 1
    assert compare(_t(k=[1, 2, 4], v=[6.0, 5.0, 4.0]), ref, [("v", False)],
                   1e-9)[0] == 1
    assert compare(_t(k=[1, 2, 3]), ref, (), 1e-9)[0] == 3


def test_compare_measures_gaps_against_the_column():
    ref = _t(k=[1, 2], v=[1000.0, 0.0])
    wrong, gap = compare(_t(k=[1, 2], v=[1000.0, 1e-3]), ref, (), 1e-9)
    assert wrong == 0 and gap == pytest.approx(1e-6)
    assert compare(_t(v=[np.nan]), _t(v=[1.0]))[1] == float("inf")


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_draws_clause_2_4s_ranges_less_what_it_withholds(mix):
    """The mix states the specification's ranges; only the values it lists
    as withheld, each with its reason, are never drawn."""
    spec = _json("traffic", f"{mix}.json")
    q1 = spec["parameters"]["1"]["q1_cutoff"]
    disc = spec["parameters"]["6"]["q6_discount"]
    assert (q1["lo"], q1["hi"]) == (60, 120)
    assert (disc["lo"], disc["hi"], disc["step"]) == (0.02, 0.09, 0.01)
    assert q1["why_withheld"] and disc["why_withheld"]
    cutoff = loadgen.days("1998-12-01")
    deltas, discounts = set(), set()
    for seed in range(200):
        b = loadgen.bindings(spec, seed)
        deltas |= {cutoff - x["q1_cutoff"] for x in b[1]}
        discounts |= {round(x["q6_disc_lo"] + 0.01, 9) for x in b[6]}
    assert deltas == set(range(60, 121)) - set(q1["withheld"])
    assert discounts == {round(0.02 + 0.01 * k, 9) for k in range(8)} - \
        set(disc["withheld"])
