"""The port's partition histogram, counting rank and skew statistics against
the reference package's (``repro.kernels.radix_hist.ops``).

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs both its jnp oracle leg and its Pallas kernel in interpret
mode.  The same numpy keys go to both, and everything must be exactly equal:
histograms are integer counts, ranks are positions.  The CUDA kernels are
held against these plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.radix_hist import ops as R

from repro_torch.kernels.radix_hist import ops as P
from repro_torch.kernels.radix_hist import ref as P_ref
from repro_torch.kernels.hash_probe import ref as hp_ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stable_rank(keys: np.ndarray, parts: int) -> np.ndarray:
    """Position within its key group that a stable argsort gives each row."""
    order = np.argsort(keys, kind="stable")
    pos = np.empty(len(keys), np.int64)
    pos[order] = np.arange(len(keys))
    start = np.concatenate([[0], np.cumsum(np.bincount(keys,
                                                       minlength=parts))])
    return pos - start[keys]


@pytest.mark.parametrize("n", [0, 1, 7, 2048, 5001])
@pytest.mark.parametrize("parts", [5, 9, 129])
@pytest.mark.parametrize("hashed", [True, False])
def test_radix_hist_equals_reference(n, parts, hashed):
    rng = np.random.default_rng(n * 31 + parts)
    keys = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    got = P.radix_hist(_t(keys), parts, hashed=hashed)
    want = np.asarray(R.radix_hist(jnp.asarray(keys), parts, use_kernel=False,
                                   hashed=hashed))
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if n:
        kern = np.asarray(R.radix_hist(jnp.asarray(keys), parts,
                                       use_kernel=True, interpret=True,
                                       hashed=hashed))
        np.testing.assert_array_equal(got.numpy(), kern)


@pytest.mark.parametrize("blk", [8, 512, 2048])
def test_radix_hist_block_sizes(blk):
    keys = np.random.default_rng(blk).integers(0, 1000, 3000).astype(np.int32)
    got = P.radix_hist(_t(keys), 8, blk=blk)
    want = np.asarray(R.radix_hist(jnp.asarray(keys), 8, blk=blk,
                                   use_kernel=False))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 10_000])
@pytest.mark.parametrize("parts", [5, 9, 129, 4096])
def test_counting_rank_equals_reference(n, parts):
    rng = np.random.default_rng(n + parts)
    keys = rng.integers(0, parts, n).astype(np.int32)
    slot, counts = P.counting_rank(_t(keys), parts)
    assert slot.dtype == counts.dtype == torch.int32
    assert slot.shape == (n,) and counts.shape == (parts,)
    ws, wc = R.counting_rank(jnp.asarray(keys), parts, use_kernel=False)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(slot.numpy(), _stable_rank(keys, parts))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(keys, minlength=parts))


@pytest.mark.parametrize("n", [1, 513, 3000])
def test_counting_rank_equals_pallas_interpret(n):
    keys = np.random.default_rng(n).integers(0, 9, n).astype(np.int32)
    slot, counts = P.counting_rank(_t(keys), 9)
    ks, kc = R.counting_rank(jnp.asarray(keys), 9, use_kernel=True,
                             interpret=True)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(kc))


def test_counting_rank_every_key_in_the_drop_bucket():
    """The shuffle's drop bucket (padding rows) is the last key: ranked like
    any other, and counted."""
    parts = 5
    keys = np.full(3000, parts - 1, np.int32)
    slot, counts = P.counting_rank(_t(keys), parts)
    np.testing.assert_array_equal(slot.numpy(), np.arange(3000))
    np.testing.assert_array_equal(counts.numpy(), [0, 0, 0, 0, 3000])


def test_counting_rank_one_key():
    slot, counts = P.counting_rank(_t(np.array([3], np.int32)), 9)
    assert slot.tolist() == [0]
    assert counts.tolist() == [0, 0, 0, 1, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("blk", [8, 2048, 4096])
def test_counting_rank_independent_of_block(blk, monkeypatch):
    monkeypatch.setattr(P_ref, "RANK_BLK", blk)
    keys = np.random.default_rng(3).integers(0, 9, 9000).astype(np.int32)
    slot, counts = P_ref.counting_rank_ref(_t(keys), 9)
    np.testing.assert_array_equal(slot.numpy(), _stable_rank(keys, 9))


@pytest.mark.parametrize("hashed", [True, False])
def test_skew_stats_equals_reference(hashed):
    rng = np.random.default_rng(5)
    # a hot key on a quarter of the rows, as JCC-H skews a foreign key
    keys = np.where(rng.random(20_000) < 0.25, 17,
                    rng.integers(0, 50_000, 20_000)).astype(np.int32)
    got = P.skew_stats(_t(keys), 8, hashed=hashed)
    want = R.skew_stats(jnp.asarray(keys), 8, use_kernel=False, hashed=hashed)
    np.testing.assert_array_equal(got["per_partition"].numpy(),
                                  np.asarray(want["per_partition"]))
    assert float(got["max"]) == float(want["max"])
    assert float(got["imbalance"]) == float(want["imbalance"])


def test_murmur32_is_shared_by_both_kernels():
    """One murmur32 for the histogram's binning and the bucket hash."""
    assert hp_ref.murmur32 is P_ref.murmur32
    x = np.array([0, 1, -1, 2**31 - 1, -2**31, 123456789], np.int32)
    from repro.kernels.radix_hist.kernel import murmur32 as jmurmur
    np.testing.assert_array_equal(
        P_ref.murmur32(_t(x)).numpy(),
        np.asarray(jmurmur(jnp.asarray(x))).astype(np.int64))


def test_cuda_wrappers_refuse_oversized_parts():
    """The kernels' shared memory bounds parts; a wrapper says so before it
    touches a device.  On ``meta`` the counting rank gives its shapes alone
    (the custom op's fake implementation, which the LM dry-run runs), under
    the kernel's bounds."""
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    slot, counts = P.counting_rank(meta, 9)
    assert (slot.device.type, tuple(slot.shape), slot.dtype) == \
        ("meta", (10,), torch.int32)
    assert (tuple(counts.shape), counts.dtype) == ((9,), torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        P.radix_hist(meta, 9)
    with pytest.raises(ValueError, match="parts must be in"):
        P.counting_rank(meta, P.COUNTING_RANK_PARTS_MAX + 1)
    with pytest.raises(ValueError, match="parts must be in"):
        P.radix_hist(meta, P.RADIX_HIST_PARTS_MAX + 1)


@pytest.mark.parametrize("n,width,design,size", [
    (1, 2, "single_pass", 2 + 1),
    (4096, 6, "single_pass", 6 + 1),
    (4097, 6, "single_pass", 2 * 6 + 1),
    (15_000_000, 6, "single_pass", 3663 * 6 + 1),   # N = 4: parts 5, width 6
    (60_000_000, 10, "single_pass", 14649 * 10 + 1),  # N = 8
    (1000, 32, "single_pass", 32 + 1),
    (1000, 33, "three_pass", 33),
    (15_000_000, 64, "three_pass", 3663 * 64),
    (8193, 4097, "three_pass", 3 * 4097),
])
def test_rank_design_and_scratch(n, width, design, size):
    """The shuffle's widths (N + 2) take the single pass; its scratch holds
    each tile's look-back word per bin and the ticket, as int64."""
    assert P.rank_design(width) == design
    want_dtype = torch.int64 if design == "single_pass" else torch.int32
    assert P.rank_scratch(n, width) == (size, want_dtype)


@pytest.mark.parametrize("parts,per_sm", [
    (1, 8), (8, 8), (32, 8), (33, 8), (64, 8), (4096, 8),
    (8192, 6), (12288, 4),       # 32 KB and 48 KB a block, + 1 KB each
])
def test_hist_plan_per_width(parts, per_sm):
    """One copy of the histogram a block, ``parts`` ints of shared memory
    (what the launch gets), up to 12288 bins; at SF 10's 60 M rows the grid
    is persistent, 8 blocks an SM while their shared memory fits."""
    plan = P.hist_plan(60_000_000, parts, 2048)
    assert plan == P.HistPlan(vector=True, nblocks=per_sm * 132,
                              smem=parts * 4)
    assert plan.smem + 1024 <= 232_448


@pytest.mark.parametrize("blk,aligned,vector", [
    (2048, True, True), (2048, False, False),      # keys[1:] of an int32 tensor
    (8, True, True), (100, True, True), (102, True, False), (2047, True, False),
])
def test_hist_plan_loads_lane_by_lane_unless_aligned(blk, aligned, vector):
    """16-byte loads need the keys 16-byte aligned and every chunk to start
    on a multiple of 4 rows (blk % 4 == 0); else lane by lane."""
    assert P.hist_plan(300_001, 8, blk, aligned).vector == vector


@pytest.mark.parametrize("n,blk,nblocks", [
    (1, 8, 1), (2048, 2048, 1), (2049, 2048, 2), (300_001, 100, 1056),
    (60_000_000, 2048, 1056)])
def test_hist_plan_grid_never_exceeds_the_blocks(n, blk, nblocks):
    assert P.hist_plan(n, 8, blk).nblocks == nblocks


@pytest.mark.parametrize("parts", [0, P.RADIX_HIST_PARTS_MAX + 1])
def test_hist_plan_refuses_widths_out_of_range(parts):
    with pytest.raises(ValueError, match="parts must be in"):
        P.hist_plan(1000, parts, 2048)
