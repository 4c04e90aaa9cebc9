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


def test_sum_plan_tiles_fit_and_depend_only_on_shapes():
    smem = 200 * 1024
    # Q1's shape (8 groups x 5 float64 sums): one tile of per-thread partials
    nb, chunk, gt, ct, warps = ss.sum_plan(60_000_000, 8, 5, 8, False)
    assert (gt, ct) == (8, 5) and nb * chunk >= 60_000_000
    # Q7's shape (2^11 groups, 2 sums): per-warp partials, all in one tile
    nb, chunk, gt, ct, warps = ss.sum_plan(60_000_000, 2049, 2, 8, False)
    assert (gt, ct) == (2049, 2) and 4 <= warps <= 8
    assert warps * gt * ct * 8 <= smem and nb * chunk >= 60_000_000
    # direct domain 2^13 + 1 with five float64 sums: one column at a time
    nb, chunk, gt, ct, warps = ss.sum_plan(60_000_000, 8193, 5, 8, False)
    assert (gt, ct) == (8193, 1) and warps * gt * 8 <= smem and warps >= 1
    # a group domain larger than shared memory is tiled over groups
    nb, chunk, gt, ct, warps = ss.sum_plan(1000, 100_000, 1, 8, True)
    assert ct == 1 and 0 < gt < 100_000 and warps * gt * 8 <= smem
    assert nb == 1 and chunk == 1000
    assert ss.sum_plan(5, 3, 2, 4, False) == ss.sum_plan(5, 3, 2, 4, False)


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU tensors take the plain version."""
    g = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ss.segment_reduce(g, torch.zeros(4, device="meta"), 2, "sum")
    k = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hg.build_group_dict(k, torch.ones(4, dtype=torch.bool, device="meta"),
                            16)
    plane = torch.zeros((128, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hp.hash_probe64(k, plane, plane, plane)


def test_wrappers_refuse_mismatched_shapes():
    """Checked before any pointer could reach a kernel."""
    g = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        ss.segment_reduce(g, torch.zeros(5), 2, "sum")
    with pytest.raises(ValueError, match=r"\(n,\)"):
        hg.build_group_dict(torch.zeros(4, dtype=torch.int64),
                            torch.ones(3, dtype=torch.bool), 16)
    plane = torch.zeros((128, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="one \\(B, C\\) shape"):
        hp.hash_probe64(torch.zeros(4, dtype=torch.int64), plane,
                        plane[:, :8], plane)


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


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [2, 16])
def test_bucket_table_and_probe_match_reference(cap):
    """Tables bit-identical (cap 2 overflows), probes identical to the
    reference's Pallas probe in interpret mode."""
    rng = np.random.default_rng(cap)
    m, buckets = 600, 128
    keys = rng.choice(np.arange(-5000, 5000), m, replace=False).astype(np.int64)
    keys[:3] = [keys[3], keys[3], (7 << 32) | 5]     # duplicates, packed key
    vals = np.arange(m, dtype=np.int32)
    valid = rng.random(m) < 0.9
    got = hp.build_bucket_table64(_t(keys), _t(vals), buckets, cap=cap,
                                  valid=_t(valid))
    want = hp_ref_ops.build_bucket_table64(
        jnp.asarray(keys), jnp.asarray(vals), buckets, cap=cap,
        valid=jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == (cap == 2)
    probe = np.concatenate([keys, rng.integers(-6000, 6000, 300),
                            [np.iinfo(np.int64).max]]).astype(np.int64)
    row = hp.hash_probe64(_t(probe), *got[:3])
    want_row = hp_ref_ops.hash_probe64(jnp.asarray(probe), *want[:3],
                                       interpret=True)
    np.testing.assert_array_equal(row.numpy(), np.asarray(want_row))
    assert hp.next_pow2(1200) == hp_ref_ops.next_pow2(1200) == 2048
