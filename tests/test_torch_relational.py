"""Port relational operators (repro_torch.core.relational) against the
reference package's (repro.core.relational), operator by operator.

Both engines get the same numpy columns and masks.  Valid rows, their order,
counts and overflow flags must be exactly equal; float aggregates to 1e-12
relative (the engines add in different orders).  Compaction is compared over
the whole capacity, garbage rows included: the port's sort-free compaction
must reproduce the reference's stable argsort permutation exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import backend as RB
from repro.core import relational as R
from repro.core import table as RT

from repro_torch.core import relational as P
from repro_torch.core import table as PT

CAP = 256


def _data(seed=0, n=181):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, 12, n).astype(np.int64),
        "k2": rng.integers(0, 5, n).astype(np.int64),
        "neg": rng.integers(-40, 40, n).astype(np.int64),
        "code": rng.integers(0, 7, n).astype(np.int32),
        "v": rng.normal(size=n),
        "q": rng.integers(1, 50, n).astype(np.int64),
    }


def _pair(cols, cap=CAP, mask=None):
    """(reference Table, port Table) of the same columns, optionally masked
    by a numpy predicate over the padded rows."""
    r = RT.from_numpy(cols, capacity=cap)
    p = PT.from_numpy(cols, capacity=cap, device="cpu")
    if mask is not None:
        r = R.filter_rows(r, jnp.asarray(mask))
        p = P.filter_rows(p, torch.from_numpy(mask))
    return r, p


def test_from_numpy_defaults_to_cuda():
    """Like every entry point of the port, ``from_numpy`` puts the table on
    the card unless the caller names a device, and raises without one."""
    cols = _data(n=5)
    if torch.cuda.is_available():
        assert PT.from_numpy(cols).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PT.from_numpy(cols)
    assert PT.from_numpy(cols, device="cpu").device.type == "cpu"


def _mask(cols, cap=CAP, seed=1):
    return np.random.default_rng(seed).random(cap) < 0.6


def _assert_same(got, want, rtol=0.0):
    g, w = PT.to_numpy(got), RT.to_numpy(want)
    assert set(g) == set(w)
    assert int(got.count) == int(want.count)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        if w[k].dtype.kind == "f" and rtol:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_filter_compact_limit_shrink(masked):
    d = _data()
    r, p = _pair(d, mask=_mask(d) if masked else None)
    keep = np.asarray(d["q"] > 20)
    keep = np.concatenate([keep, np.zeros(CAP - len(keep), bool)])
    rc = R.compact(r, jnp.asarray(keep))
    pc = P.compact(p, torch.from_numpy(keep))
    assert int(pc.count) == int(rc.count)
    for k in d:      # whole capacity: the same permutation, garbage included
        np.testing.assert_array_equal(pc[k].numpy(), np.asarray(rc[k]))
    _assert_same(P.filter_rows(p, p["k"] < 6), R.filter_rows(r, r["k"] < 6))
    _assert_same(P.limit(p, 17), R.limit(r, 17))
    for cap in (8, 200):
        pt, pov = P.static_shrink(p, cap)
        rt, rov = R.static_shrink(r, cap)
        _assert_same(pt, rt)
        assert bool(pov) == bool(rov)


def test_combine_keys_and_hash_partition_ids():
    d = _data()
    r, p = _pair(d)
    for bits in (None, [4, 3]):
        got = P.combine_keys([p["k"], p["k2"]], bits=bits)
        want = R.combine_keys([r["k"], r["k2"]], bits=bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        P.combine_keys([p["k"]] * 3)
    rng = np.random.default_rng(9)
    keys = rng.integers(-2**62, 2**62, 5000).astype(np.int64)
    keys[:4] = [0, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    for n in (1, 7, 8, 1000):
        got = P.hash_partition_ids(torch.from_numpy(keys), n).numpy()
        np.testing.assert_array_equal(got, RB.hash_partition_np(keys, n))
        np.testing.assert_array_equal(
            got, np.asarray(R.hash_partition_ids(jnp.asarray(keys), n)))


@pytest.mark.parametrize("method", ["sorted", "hash"])
@pytest.mark.parametrize("masked", [False, True])
def test_joins_match_reference(method, masked):
    d = _data(2)
    r, p = _pair(d, mask=_mask(d, seed=3) if masked else None)
    bcols = {"bk": np.arange(0, 16, 2, dtype=np.int64),
             "bv": np.arange(8) * 2.5, "bi": np.arange(8, dtype=np.int32)}
    rb, pb = _pair(bcols, cap=16, mask=np.arange(16) != 3)
    ri = R.build_index(rb, rb["bk"], method)
    pi = P.build_index(pb, pb["bk"], method)
    _assert_same(P.join_unique(p, pb, p["k"], pb["bk"], ["bv", "bi"], pi),
                 R.join_unique(r, rb, r["k"], rb["bk"], ["bv", "bi"], ri))
    _assert_same(P.semi_join(p, pb, p["k"], pb["bk"], pi),
                 R.semi_join(r, rb, r["k"], rb["bk"], ri))
    _assert_same(P.anti_join(p, pb, p["k"], pb["bk"], pi),
                 R.anti_join(r, rb, r["k"], rb["bk"], ri))
    defaults = {"bv": -1.0, "bi": -7}
    _assert_same(P.left_join(p, pb, p["k"], pb["bk"], ["bv", "bi"], defaults,
                             pi),
                 R.left_join(r, rb, r["k"], rb["bk"], ["bv", "bi"], defaults,
                             ri))
    assert bool(pi.overflow) == bool(ri.overflow) is False


@pytest.mark.parametrize("method", ["sorted", "hash"])
def test_join_against_empty_build(method):
    d = _data(4)
    r, p = _pair(d)
    bcols = {"bk": np.arange(4, dtype=np.int64), "bv": np.ones(4)}
    rb, pb = _pair(bcols, cap=8, mask=np.zeros(8, bool))
    _assert_same(P.join_unique(p, pb, p["k"], pb["bk"], ["bv"], method=method),
                 R.join_unique(r, rb, r["k"], rb["bk"], ["bv"], method=method))


def test_hash_index_overflow_flag_matches():
    cols = {"bk": np.arange(4000, dtype=np.int64)}
    rb, pb = _pair(cols, cap=4000)
    ri = R.build_index(rb, rb["bk"], "hash", bucket_cap=2)
    pi = P.build_index(pb, pb["bk"], "hash", bucket_cap=2)
    assert bool(pi.overflow) == bool(ri.overflow) is True


_AGGS = [("s", "sum", "v"), ("c", "count", None), ("mn", "min", "v"),
         ("mx", "max", "v"), ("qs", "sum", "q"), ("qmn", "min", "q"),
         ("qmx", "max", "neg")]


@pytest.mark.parametrize("path", ["direct", "hash", "sort", "scalar"])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_paths_match_reference(path, masked):
    d = _data(5)
    r, p = _pair(d, mask=_mask(d, seed=6) if masked else None)
    keys, kw = ["k", "k2"], {}
    if path == "direct":
        kw = dict(key_bits=[4, 3], method="direct")
    elif path == "hash":
        kw = dict(groups_hint=60, method="hash")
    elif path == "sort":
        kw = dict(method="sort")
    else:
        keys = []
    pt, pov = P.group_aggregate(p, keys, _AGGS, return_overflow=True, **kw)
    rt, rov = R.group_aggregate(r, keys, _AGGS, return_overflow=True,
                                use_kernel=False, **kw)
    _assert_same(pt, rt, rtol=1e-12)
    assert bool(pov) == bool(rov) is False


def test_group_aggregate_negative_keys_hash_path():
    d = _data(7)
    r, p = _pair(d)
    pt = P.group_aggregate(p, ["neg"], _AGGS, groups_hint=100, method="hash")
    rt = R.group_aggregate(r, ["neg"], _AGGS, groups_hint=100, method="hash",
                           use_kernel=False)
    _assert_same(pt, rt, rtol=1e-12)


@pytest.mark.parametrize("case", ["lying_bits", "hint_undercount", "empty"])
def test_group_aggregate_overflow_and_empty(case):
    d = _data(8)
    mask = np.zeros(CAP, bool) if case == "empty" else None
    r, p = _pair(d, mask=mask)
    if case == "lying_bits":           # k reaches 11: 3 bits lie
        kw = dict(key_bits=[3, 3], method="direct")
    elif case == "hint_undercount":    # 60 groups, hint 5 -> 16-slot dict
        kw = dict(groups_hint=5, method="hash")
    else:
        kw = dict(key_bits=[4, 3], method="direct")
    pt, pov = P.group_aggregate(p, ["k", "k2"], _AGGS, return_overflow=True,
                                **kw)
    rt, rov = R.group_aggregate(r, ["k", "k2"], _AGGS, return_overflow=True,
                                use_kernel=False, **kw)
    _assert_same(pt, rt, rtol=1e-12)
    assert bool(pov) == bool(rov) == (case != "empty")


@pytest.mark.parametrize("masked", [False, True])
def test_sort_by_multikey_matches_reference(masked):
    d = _data(10)
    d["v"][:20] = d["v"][20:40]            # float ties
    r, p = _pair(d, mask=_mask(d, seed=11) if masked else None)
    for keys in ([("k", True), ("v", False)], [("code", False), ("k2", True),
                                               ("q", False)]):
        _assert_same(P.sort_by(p, keys), R.sort_by(r, keys))
