"""Port kernels (repro_torch.kernels) against the reference package's.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those against ``repro.kernels`` (the jnp oracles, or the Pallas kernels in
interpret mode) on the same numpy inputs.  Integers, ids, keys and flags must
match exactly; float sums to 1e-9 relative (the kernel-vs-oracle tolerance
the reference planner pins), since the two engines add in other orders.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hash_group import ops as hg_ref_ops
from repro.kernels.hash_group import ref as hg_ref
from repro.kernels.hash_probe import kernel as hp_ref_kernel
from repro.kernels.hash_probe import ops as hp_ref_ops
from repro.kernels.radix_hist import kernel as rh_ref_kernel
from repro.kernels.segsum import ops as ss_ref

from repro_torch.kernels.hash_group import ops as hg
from repro_torch.kernels.hash_group import ref as hg_plain
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.hash_probe import ref as hp_plain
from repro_torch.kernels.segsum import ops as ss

_NP = {"int32": np.int32, "int64": np.int64, "float64": np.float64}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# segsum
# ---------------------------------------------------------------------------

def _values(rng, dtype, n, c=None):
    shape = (n,) if c is None else (n, c)
    if dtype == "float64":
        return rng.normal(size=shape) * 100.0
    return rng.integers(-1000, 1000, shape).astype(_NP[dtype])


def _assert_reduced(got, want, dtype):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 127, 255, 2049])
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
def test_segment_reduce_matches_reference(dtype, op, groups):
    """Every op x dtype, with ids below 0, in the dead slot and past it,
    and empty groups (more groups than the rows can fill at 2049)."""
    rng = np.random.default_rng(groups * 7 + len(op))
    n = 700
    gids = rng.integers(-3, groups + 4, n).astype(np.int32)
    v = _values(rng, dtype, n)
    got = ss.segment_reduce(_t(gids), _t(v), groups, op)
    want = ss_ref.segment_reduce(jnp.asarray(gids), jnp.asarray(v), groups,
                                 op=op, use_kernel=False)
    _assert_reduced(got, want, "int64" if op == "count" else dtype)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_multicolumn_vs_pallas_interpret(op):
    """(n, C) float64 against the Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(3)
    n, groups = 300, 127
    gids = rng.integers(0, groups + 1, n).astype(np.int32)
    v = _values(rng, "float64", n, 3)
    got = ss.segment_reduce(_t(gids), _t(v), groups, op)
    want = ss_ref.segment_reduce(jnp.asarray(gids), jnp.asarray(v), groups,
                                 op=op, interpret=True, use_kernel=True)
    _assert_reduced(got, want, "float64")


def test_segment_reduce_empty_and_all_dead():
    for n, groups in ((0, 5), (9, 5)):
        gids = np.full(n, 5, np.int32)             # every row in the dead slot
        v = np.arange(n, dtype=np.int64)
        for op in ("sum", "count", "min", "max"):
            got = ss.segment_reduce(_t(gids), _t(v), groups, op)
            want = ss_ref.segment_reduce(jnp.asarray(gids), jnp.asarray(v),
                                         groups, op=op, use_kernel=False)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_SMEM_BLOCK = 232_448       # shared memory one H100 block may use


def test_sum_plan_tiles_fit_and_depend_only_on_shapes():
    n = 60_000_000
    # Q1's shape (8 groups x 5 float64 sums): one tile of per-thread partials
    p = ss.sum_plan(n, 8, 5, torch.float64)
    assert (p.regime, p.gt, p.ct) == ("thread", 8, 5)
    assert p.smem <= _SMEM_BLOCK and p.nblocks * p.chunk >= n
    # Q7's shape (2^11 + 1 groups x 2 float64 sums): a copy per warp, one
    # tile, a persistent grid whose partial is at most 8 MB (was 60 MB)
    p = ss.sum_plan(n, 2049, 2, torch.float64)
    assert (p.regime, p.gt, p.ct) == ("warp", 2049, 2) and 4 <= p.warps <= 8
    assert p.smem == p.warps * (2049 * 2 * 8 + 4096) <= _SMEM_BLOCK
    assert p.nblocks <= 264 and p.partial * 8 <= 8 * 2**20
    assert p.partial == p.nblocks * 2049 * 2 and (p.nblocks - 1) * p.chunk < n
    # direct domain 2^13 + 1 with five float64 sums: one column at a time
    p = ss.sum_plan(n, 8193, 5, torch.float64)
    assert (p.gt, p.ct) == (8193, 1) and p.smem <= _SMEM_BLOCK
    # a group domain larger than shared memory is tiled over groups
    p = ss.sum_plan(1000, 100_000, 1, torch.float64)
    assert p.ct == 1 and 0 < p.gt < 100_000 and p.smem <= _SMEM_BLOCK
    assert p.nblocks == 1 and p.chunk >= 1000
    # integers and counts take atomics: no partial, one copy of the tile per
    # block at least while it fits (32-bit counters for the count)
    p = ss.sum_plan(n, 8193, 1, torch.int64, count=True)
    assert (p.regime, p.partial) == ("atomic", 0)
    assert p.warps >= 1 and p.smem == p.warps * 8193 * 4 <= 96 * 1024
    assert p.chunk < 2**31
    p = ss.sum_plan(n, 2049, 2, torch.int64)
    assert (p.regime, p.ct, p.partial) == ("atomic", 2, 0)
    assert p.smem == p.warps * 2049 * 2 * 8
    assert ss.sum_plan(n, 100_000, 1, torch.int64, count=True).warps == 0
    # the geometry is a function of the shapes: the same plan every time,
    # for the same shapes, whatever the data
    for args in ((5, 3, 2, torch.float64), (n, 2049, 2, torch.float32),
                 (n, 1, 1, torch.float64)):
        assert ss.sum_plan(*args) == ss.sum_plan(*args)


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU tensors take the plain version."""
    g = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ss.segment_reduce(g, torch.zeros(4, device="meta"), 2, "sum")
    k = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hg.build_group_dict(k, torch.ones(4, dtype=torch.bool, device="meta"),
                            16)
    heads = torch.zeros((128, 8), dtype=torch.int32, device="meta")
    tails = torch.zeros((5, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hp.hash_probe64(k, heads, tails)


def test_wrappers_refuse_mismatched_shapes():
    """Checked before any pointer could reach a kernel."""
    g = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        ss.segment_reduce(g, torch.zeros(5), 2, "sum")
    with pytest.raises(ValueError, match=r"\(n,\)"):
        hg.build_group_dict(torch.zeros(4, dtype=torch.int64),
                            torch.ones(3, dtype=torch.bool), 16)
    heads = torch.zeros((128, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="\\(R, 2\\) tail"):
        hp.hash_probe64(torch.zeros(4, dtype=torch.int64), heads,
                        torch.zeros((5, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="\\(B, 8\\) heads"):
        hp.hash_probe64(torch.zeros(4, dtype=torch.int64), heads[:, :4],
                        torch.zeros((5, 2), dtype=torch.int64))


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

def test_murmur32_and_bucket_of_bit_exact():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    x[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    got = hp_plain.murmur32(_t(x)).numpy()
    want = np.asarray(rh_ref_kernel.murmur32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    keys = rng.integers(-2**62, 2**62, 4096).astype(np.int64)
    keys[:3] = [0, -1, np.iinfo(np.int64).max]
    lo, hi = hp_plain.split64(_t(keys))
    rlo, rhi = hp_ref_ops._split64(jnp.asarray(keys))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    for buckets in (128, 1000, 1 << 20):
        got = hp_plain.bucket_of(lo, hi, buckets).numpy()
        want = np.asarray(hp_ref_kernel.bucket_of(rlo, rhi, buckets))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# hash_group
# ---------------------------------------------------------------------------

def _group_keys(seed, n, distinct):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-2**40, 2**40, distinct).astype(np.int64)
    pool[0] = np.iinfo(np.int64).min + 1
    keys = pool[rng.integers(0, distinct, n)]
    valid = rng.random(n) < 0.85
    return keys, valid


@pytest.mark.parametrize("cap,distinct", [(16, 9), (64, 40), (512, 40),
                                          (64, 200)])
def test_build_group_dict_matches_reference(cap, distinct):
    """Same lockstep algorithm, so the slot layout is identical too; the
    contract (ascending dense ids, unresolved iff a valid row was not
    placed) is checked against the NumPy oracle.  (64, 200) overfills the
    dictionary."""
    keys, valid = _group_keys(cap + distinct, 500, distinct)
    rounds = hg.default_rounds(cap)
    slot, dk, occ, unres = hg.build_group_dict(_t(keys), _t(valid), cap)
    rslot, rdk, rocc, runres = hg_ref.hash_insert_ref(
        jnp.asarray(keys), jnp.asarray(valid), cap, rounds)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(rocc))
    np.testing.assert_array_equal(dk.numpy()[occ.numpy()],
                                  np.asarray(rdk)[np.asarray(rocc)])
    assert bool(unres) == bool(runres) == (distinct > cap)
    rank = hg.dict_rank(dk, occ)
    np.testing.assert_array_equal(rank.numpy(),
                                  np.asarray(hg_ref_ops.dict_rank(rdk, rocc)))
    if not bool(unres):
        gid = torch.where(slot >= 0, rank[slot.clamp(min=0).long()], -1)
        want, _ = hg_ref.group_ids_np(keys, valid)
        np.testing.assert_array_equal(gid.numpy(), want)


def test_dict_capacity_and_empty_input():
    for hint, factor in ((1, 2.0), (100, 2.0), (4096, 2.0), (300, 4.0)):
        assert hg.dict_capacity(hint, factor) == \
            hg_ref_ops.dict_capacity(hint, factor)
    slot, dk, occ, unres = hg_plain.hash_insert_ref(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool),
        16, 16)
    assert slot.shape == (0,) and not bool(occ.any()) and not bool(unres)


def test_insert_design_is_chosen_by_cap():
    """The shared design up to 4096 slots (12 bytes a slot in a block's
    48 KB of shared memory), the global one above."""
    for cap in (16, 512, 1000, 4096):
        assert hg.insert_design(cap) == "shared"
    for cap in (4097, 8192, 1 << 20):
        assert hg.insert_design(cap) == "global"


@pytest.mark.parametrize("case", ["no_rows", "no_valid_rows", "negative",
                                  "window_exhausted"])
def test_build_group_dict_edge_cases_match_reference(case):
    """No rows, no valid rows, negative keys down to INT64_MIN, and a probe
    window too short for the keys (``rounds`` 2, so some valid row stays
    unplaced and ``unresolved`` is set): slots, dictionary and flag equal
    the reference's."""
    rng = np.random.default_rng(7)
    cap, rounds, n = 64, None, 400
    pool = -rng.integers(1, 2**62, 20).astype(np.int64)
    pool[0] = np.iinfo(np.int64).min
    if case == "no_rows":
        n = 0
    elif case == "window_exhausted":
        pool, rounds = rng.integers(-2**40, 2**40, 40).astype(np.int64), 2
    keys = pool[rng.integers(0, pool.size, n)]
    valid = rng.random(n) < (0.0 if case == "no_valid_rows" else 0.85)
    rounds = rounds or hg.default_rounds(cap)
    slot, dk, occ, unres = hg.build_group_dict(_t(keys), _t(valid), cap,
                                               rounds)
    if n == 0:              # the reference's gather refuses an empty input
        assert slot.shape == (0,) and not bool(occ.any() | unres)
        return
    rslot, rdk, rocc, runres = hg_ref.hash_insert_ref(
        jnp.asarray(keys), jnp.asarray(valid), cap, rounds)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(rocc))
    np.testing.assert_array_equal(dk.numpy()[occ.numpy()],
                                  np.asarray(rdk)[np.asarray(rocc)])
    assert bool(unres) == bool(runres) == (case == "window_exhausted")
    assert bool(unres) == bool((valid & (slot.numpy() < 0)).any())


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------

def _planes(heads, tails, cap):
    """The 64-bit table expanded back into the reference's (B, C) lo, hi and
    row planes: a bucket's n keys fill its first lanes in order (two from
    its head, the rest from its tail), empty lanes hold SENTINEL keys and
    row -1."""
    count, start = heads[:, 6].to(torch.int64), heads[:, 7].to(torch.int64)
    if tails.shape[0] == 0:                 # no bucket holds a third key
        tails = torch.zeros((1, 2), dtype=torch.int64)
    lane = torch.arange(cap)
    idx = (start[:, None] + lane - 2).clamp(0, tails.shape[0] - 1)
    keys = tails[idx, 0]
    rows = tails[idx, 1]
    head_keys = heads.view(torch.int64)[:, :2]
    keys[:, :2] = head_keys[:, :cap]
    rows[:, :2] = heads[:, 4:6][:, :cap].to(torch.int64)
    inside = lane < count[:, None]
    lo, hi = hp_plain.split64(keys)
    sentinel = torch.tensor(hp.SENTINEL, dtype=torch.int32)
    return (torch.where(inside, lo, sentinel), torch.where(inside, hi, sentinel),
            torch.where(inside, rows, -1).to(torch.int32))


def _bucket_case(seed, m, valid_share=0.9):
    """Negative keys, two duplicates, a packed two-column key, invalid rows."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(-5000, 5000), m, replace=False).astype(np.int64)
    keys[:3] = [keys[3], keys[3], (7 << 32) | 5]
    vals = rng.permutation(m).astype(np.int32)
    valid = rng.random(m) < valid_share
    probe = np.concatenate([keys, rng.integers(-6000, 6000, 300),
                            [np.iinfo(np.int64).max]]).astype(np.int64)
    return keys, vals, valid, probe


@pytest.mark.parametrize("cap", [2, 16])
def test_bucket_table_and_probe_match_reference(cap):
    """Tables equal to the reference's planes bit for bit once expanded
    (cap 2 overflows), probes identical to the reference's Pallas probe in
    interpret mode."""
    m, buckets = 600, 128
    keys, vals, valid, probe = _bucket_case(cap, m)
    vals = np.arange(m, dtype=np.int32)
    got = hp.build_bucket_table64(_t(keys), _t(vals), buckets, cap=cap,
                                  valid=_t(valid))
    want = hp_ref_ops.build_bucket_table64(
        jnp.asarray(keys), jnp.asarray(vals), buckets, cap=cap,
        valid=jnp.asarray(valid))
    for g, w in zip(_planes(got[0], got[1], cap), want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) == bool(want[3]) == (cap == 2)
    row = hp.hash_probe64(_t(probe), got[0], got[1])
    want_row = hp_ref_ops.hash_probe64(jnp.asarray(probe), *want[:3],
                                       interpret=True)
    np.testing.assert_array_equal(row.numpy(), np.asarray(want_row))
    assert hp.next_pow2(1200) == hp_ref_ops.next_pow2(1200) == 2048


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,buckets,cap", [(600, 128, 6), (600, 128, 3),
                                           (2000, 256, 16), (1, 128, 16)])
def test_bucket_table64_expands_to_reference_planes(seed, m, buckets, cap):
    """Expanded into (B, C) planes the heads-and-tails table equals the
    reference's
    build bit for bit, its overflow flag is the reference's, and the plain
    probe of the packed table equals the reference's probe of its planes,
    overflowed builds included (about 4.7 keys a bucket at m 600)."""
    keys, vals, valid, probe = _bucket_case(seed, max(m, 4))
    keys, vals, valid = keys[:m], vals[:m], valid[:m]
    heads, tails, ov = hp.build_bucket_table64(
        _t(keys), _t(vals), buckets, cap=cap, valid=_t(valid))
    want = hp_ref_ops.build_bucket_table64(
        jnp.asarray(keys), jnp.asarray(vals), buckets, cap=cap,
        valid=jnp.asarray(valid))
    assert heads.dtype == torch.int32 and heads.shape == (buckets, 8)
    spilled = int((heads[:, 6].to(torch.int64) - 2).clamp(min=0).sum())
    assert tails.dtype == torch.int64 and tails.shape == (spilled, 2)
    for g, w in zip(_planes(heads, tails, cap), want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(ov) == bool(want[3])
    got = hp_plain.hash_probe64_ref(_t(probe), heads, tails)
    want_row = hp_ref_ops.hash_probe64(jnp.asarray(probe), *want[:3],
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_row))


def test_bucket_table64_of_no_valid_rows():
    keys = torch.arange(10, dtype=torch.int64)
    heads, tails, ov = hp.build_bucket_table64(
        keys, torch.arange(10, dtype=torch.int32), 128,
        valid=torch.zeros(10, dtype=torch.bool))
    assert int(heads[:, 6].abs().sum()) == 0 and not bool(ov)
    assert torch.equal(hp.hash_probe64(keys, heads, tails),
                       torch.full((10,), -1, dtype=torch.int32))
