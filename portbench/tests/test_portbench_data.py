"""The benchmark's data: the generator its runs use (``device_tpch``, here
on the CPU) keeps the schema, dictionaries, domains and relations of the
program's generator (``repro_torch.data.tpch``)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.data import device_tpch, tpch  # noqa: E402
from repro_torch.data import tpch as prog_tpch  # noqa: E402

SF = 0.005
VOCABULARY = ["REGIONS", "NATIONS", "NATION_REGION", "SEGMENTS", "PRIORITIES",
              "SHIPMODES", "INSTRUCTS", "ORDERSTATUS", "RETURNFLAGS",
              "LINESTATUS", "TYPES", "CONTAINERS", "BRANDS", "MFGRS",
              "COLORS", "_CURRENT", "N_COMMENT_TEMPLATES"]


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_dictionaries_equal_the_programs(seed):
    _, dicts = device_tpch.generate(SF, seed, device="cpu")
    db = prog_tpch.generate(SF, seed=seed)
    assert sorted(dicts) == sorted(db.dicts)
    for c, d in db.dicts.items():
        np.testing.assert_array_equal(dicts[c], d, err_msg=c)


def test_vocabulary_and_dates_equal_the_programs():
    for name in VOCABULARY:
        np.testing.assert_array_equal(getattr(tpch, name),
                                      getattr(prog_tpch, name), err_msg=name)
    for d in ("1970-01-01", "1992-01-01", "1995-06-17", "1998-12-01"):
        assert tpch.days(d) == prog_tpch.days(d), d


@pytest.fixture(scope="module", params=[2**31 + 7, 5], ids=["seed_a",
                                                          "seed_b"])
def both(request):
    seed = request.param
    db = prog_tpch.generate(0.01, seed=seed)
    made = device_tpch.generate(0.01, seed, device="cpu")
    return (db.tables, db.dicts), made


def test_device_generator_has_the_programs_schema_and_dictionaries(both):
    (ft, fd), (dt, dd) = both
    assert sorted(ft) == sorted(dt)
    for name in ft:
        assert sorted(ft[name]) == sorted(dt[name]), name
        for c in ft[name]:
            assert ft[name][c].dtype == dt[name][c].dtype, (name, c)
    for name in ("region", "nation", "supplier", "customer", "part",
                 "partsupp", "orders"):
        assert len(dt[name][next(iter(dt[name]))]) == \
            len(ft[name][next(iter(ft[name]))]), name
    for c in fd:
        np.testing.assert_array_equal(fd[c], dd[c], err_msg=c)


def test_device_generator_keeps_the_programs_domains(both):
    (ft, _), (dt, _) = both
    for name in ft:
        for c, f in ft[name].items():
            d = dt[name][c]
            if c in ("l_orderkey", "l_linenumber"):
                continue
            # the same domain: no value far outside the program's
            lo, hi = f.min(), f.max()
            span = max(hi - lo, 1)
            assert d.min() >= lo - 0.2 * span and \
                d.max() <= hi + 0.2 * span, (name, c, d.min(), d.max(),
                                              lo, hi)


def test_device_generator_keeps_the_programs_relations(both):
    _, (t, _) = both
    li, o, ps, c = t["lineitem"], t["orders"], t["partsupp"], t["customer"]
    n_supp = len(t["supplier"]["s_suppkey"])
    # every (l_partkey, l_suppkey) is a partsupp pair
    w = n_supp + 1
    assert np.isin(li["l_partkey"] * w + li["l_suppkey"],
                   ps["ps_partkey"] * w + ps["ps_suppkey"]).all()
    # lines of an order are contiguous, numbered 1.., 1-7 of them
    assert (np.diff(li["l_orderkey"]) >= 0).all()
    per = np.bincount(li["l_orderkey"], minlength=len(o["o_orderkey"]) + 1)
    assert per[1:].min() >= 1 and per.max() <= 7
    # o_totalprice is the rounded sum of its lines' charges
    charge = li["l_extendedprice"] * (1 + li["l_tax"]) * \
        (1 - li["l_discount"])
    tot = np.zeros(len(o["o_orderkey"]))
    np.add.at(tot, li["l_orderkey"] - 1, charge)
    np.testing.assert_array_equal(o["o_totalprice"], np.round(tot, 2))
    # the status flags follow the current-date rule
    cur = tpch.days(tpch._CURRENT)
    np.testing.assert_array_equal(li["l_linestatus"],
                                  (li["l_shipdate"] > cur).astype(np.int32))
    assert (li["l_returnflag"][li["l_receiptdate"] > cur] == 1).all()
    assert np.isin(li["l_returnflag"][li["l_receiptdate"] <= cur],
                   [0, 2]).all()
    n_open = np.bincount(li["l_orderkey"] - 1, weights=li["l_linestatus"],
                         minlength=len(o["o_orderkey"]))
    want = np.where(n_open == 0, 0, np.where(n_open == per[1:], 1, 2))
    np.testing.assert_array_equal(o["o_orderstatus"], want)
    np.testing.assert_array_equal(c["c_phone_cc"], c["c_nationkey"] + 10)
    # a third of the customers never order; every key names a row
    assert (o["o_custkey"] % 3 != 0).all()
    assert o["o_custkey"].min() >= 1 and \
        o["o_custkey"].max() <= len(c["c_custkey"])
    assert li["l_partkey"].min() >= 1 and \
        li["l_partkey"].max() <= len(t["part"]["p_partkey"])


def test_device_generator_is_a_function_of_the_seed():
    a, _ = device_tpch.generate(0.005, 2**31 + 11, device="cpu")
    b, _ = device_tpch.generate(0.005, 2**31 + 11, device="cpu")
    c, _ = device_tpch.generate(0.005, 2**31 + 12, device="cpu")
    for name in a:
        for col in a[name]:
            np.testing.assert_array_equal(a[name][col], b[name][col])
    assert not np.array_equal(a["lineitem"]["l_quantity"][:100],
                              c["lineitem"]["l_quantity"][:100])


@pytest.mark.gpu
def test_device_generator_on_the_card_keeps_the_relations():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, _ = device_tpch.generate(0.05, 2**31 + 9, device="cuda")
    li, ps = t["lineitem"], t["partsupp"]
    w = len(t["supplier"]["s_suppkey"]) + 1
    assert np.isin(li["l_partkey"] * w + li["l_suppkey"],
                   ps["ps_partkey"] * w + ps["ps_suppkey"]).all()
    again, _ = device_tpch.generate(0.05, 2**31 + 9, device="cuda")
    for name in t:
        for col in t[name]:
            np.testing.assert_array_equal(t[name][col], again[name][col])
