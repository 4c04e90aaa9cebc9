"""The port's 32-bit hash-join probe (repro_torch.kernels.hash_probe) against
the reference's, on the CPU.

The bucket-table build must equal the reference's bit for bit (keys, rows,
overflow flag); ``hash_join_probe`` must equal the reference's (its Pallas
kernel in interpret mode) and its sorted-build oracle ``hash_probe_ref``;
``hash_join_probe_auto`` must settle at the same capacity with the same
rows, probing once.  The build's fill counts, which ``hash_join_probe``
hands the probe, must not change an answer.  The CUDA kernel is held bit for bit against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hash_probe import ops as hp_ref
from repro.kernels.hash_probe.ref import hash_probe_ref

from repro_torch import kernels as K
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.hash_probe import ref as hp_plain


def _case(m, n, seed, lo=-(1 << 31), hi=(1 << 31) - 1):
    rng = np.random.default_rng(seed)
    bkeys = rng.choice(np.arange(lo, hi, max(1, (hi - lo) // (8 * m)),
                                 dtype=np.int64), m,
                       replace=False).astype(np.int32)
    bvals = rng.permutation(m).astype(np.int32)
    # half the probes hit, half are random (mostly misses)
    pkeys = np.concatenate([rng.choice(bkeys, n // 2),
                            rng.integers(lo, hi, n - n // 2)]).astype(np.int32)
    return bkeys, bvals, rng.permutation(pkeys)


@pytest.mark.parametrize("cap", [2, 8, 16])
@pytest.mark.parametrize("m", [1, 100, 3000])
def test_build_equals_reference(m, cap):
    bkeys, bvals, _ = _case(m, 2, seed=m + cap)
    buckets = max(128, hp.next_pow2(2 * m) // cap)
    got = hp.build_bucket_table(torch.from_numpy(bkeys),
                                torch.from_numpy(bvals), buckets, cap)
    want = hp_ref.build_bucket_table(jnp.asarray(bkeys), jnp.asarray(bvals),
                                     buckets, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("m,n", [(10, 64), (100, 500), (1000, 3000),
                                 (5000, 777)])
def test_join_probe_equals_reference(m, n):
    bkeys, bvals, pkeys = _case(m, n, seed=n)
    K.reset_launches()
    got, overflowed = hp.hash_join_probe(pkeys, bkeys, bvals, device="cpu")
    assert K.launches["hash_probe32"] == 0        # the CPU runs the plain one
    want, want_ov = hp_ref.hash_join_probe(
        jnp.asarray(pkeys), jnp.asarray(bkeys), jnp.asarray(bvals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(overflowed) == bool(want_ov)
    if not bool(overflowed):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(hash_probe_ref(
                jnp.asarray(pkeys), jnp.asarray(bkeys), jnp.asarray(bvals))))


@pytest.mark.parametrize("m,n", [(100, 500), (20000, 3000)])
def test_auto_escalates_like_reference(m, n):
    """20000 keys overflow at cap 8: both settle at the same larger cap."""
    bkeys, bvals, pkeys = _case(m, n, seed=m)
    got, cap = hp.hash_join_probe_auto(pkeys, bkeys, bvals, device="cpu")
    want, want_cap = hp_ref.hash_join_probe_auto(
        jnp.asarray(pkeys), jnp.asarray(bkeys), jnp.asarray(bvals))
    assert cap == want_cap
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), hp_plain.hash_probe_ref(
            torch.from_numpy(pkeys), torch.from_numpy(bkeys),
            torch.from_numpy(bvals)).numpy())
    if m == 20000:
        assert cap > 8
        assert bool(hp.hash_join_probe(pkeys, bkeys, bvals, cap=8,
                                       device="cpu")[1])


def test_auto_raises_when_overflow_persists():
    keys = np.arange(0, 64, dtype=np.int32)
    with pytest.raises(RuntimeError, match="overflow persists"):
        hp.hash_join_probe_auto(keys, keys, keys, cap=1, max_tries=1,
                                device="cpu")


def test_sentinel_probe_and_duplicates_take_the_lane_max():
    """The plain probe is a max over all C lanes: a probe of SENTINEL meets
    the empty lanes (row -1), and a key built twice returns its larger row,
    as the reference's kernel does."""
    bkeys = np.array([5, 5, 9], dtype=np.int32)
    bvals = np.array([3, 7, 1], dtype=np.int32)
    pkeys = np.array([5, 9, hp.SENTINEL, 4], dtype=np.int32)
    got, _ = hp.hash_join_probe(pkeys, bkeys, bvals, device="cpu")
    want, _ = hp_ref.hash_join_probe(jnp.asarray(pkeys), jnp.asarray(bkeys),
                                     jnp.asarray(bvals))
    assert got.tolist() == np.asarray(want).tolist() == [7, 1, -1, -1]


def test_probe_rejects_mismatched_planes():
    with pytest.raises(ValueError):
        hp.hash_probe32(torch.zeros(4, dtype=torch.int32),
                        torch.zeros((8, 4), dtype=torch.int32),
                        torch.zeros((8, 2), dtype=torch.int32))


def test_auto_probes_once_at_the_cap_that_held(monkeypatch):
    """20000 keys from cap 2 overflow at caps 2, 4 and 8 and hold at 16:
    four builds, one probe, at the cap that held, with that build's fill
    counts; the rows and cap are the reference's loop's."""
    bkeys, bvals, pkeys = _case(20000, 3000, seed=20000)
    for cap in (2, 4, 8):
        assert bool(hp.hash_join_probe(pkeys, bkeys, bvals, cap=cap,
                                       device="cpu")[1])
    calls = []
    probe32 = hp.hash_probe32

    def counted(probe, bk, bv, counts=None):
        calls.append((bk.shape[1], counts is not None))
        return probe32(probe, bk, bv, counts)

    monkeypatch.setattr(hp, "hash_probe32", counted)
    got, cap = hp.hash_join_probe_auto(pkeys, bkeys, bvals, cap=2,
                                       device="cpu")
    assert cap == 16 and calls == [(16, True)]
    want, want_cap = hp_ref.hash_join_probe_auto(
        jnp.asarray(pkeys), jnp.asarray(bkeys), jnp.asarray(bvals), cap=2)
    assert want_cap == cap
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [1, 3, 8, 16])
def test_fill_counts_keep_sentinel_duplicates_and_minus_one_rows(cap):
    """A probe of only the filled lanes gives the answer of all C lanes: a
    key built twice returns its larger row, SENTINEL built as a key returns
    its row, a SENTINEL probe of a bucket without it meets only empty lanes
    (-1), a row of -1 stays -1; equal to the reference's probe."""
    rng = np.random.default_rng(cap)
    m = 600
    bkeys = rng.integers(-2**31, 2**31 - 1, m).astype(np.int32)
    bkeys[:20] = bkeys[20:40]                          # duplicates
    bkeys[50] = hp.SENTINEL
    bvals = rng.permutation(m).astype(np.int32)
    bvals[60:70] = -1
    pkeys = np.concatenate([rng.choice(bkeys, 900),
                            np.full(3, hp.SENTINEL, np.int32),
                            rng.integers(-2**31, 2**31 - 1, 300)]
                           ).astype(np.int32)
    buckets = max(128, hp.next_pow2(2 * m) // cap)
    tk, tv, fill, _ = hp._bucket_table(torch.from_numpy(bkeys),
                                       torch.from_numpy(bvals), buckets, cap)
    probe = torch.from_numpy(pkeys)
    got = hp.hash_probe32(probe, tk, tv, fill)
    assert torch.equal(got, hp.hash_probe32(probe, tk, tv))
    want, _ = hp_ref.hash_join_probe(jnp.asarray(pkeys), jnp.asarray(bkeys),
                                     jnp.asarray(bvals), cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lanes = torch.arange(cap)
    assert bool((tv[lanes >= fill[:, None]] == -1).all())
    assert bool((tk[lanes >= fill[:, None]] == hp.SENTINEL).all())


@pytest.mark.parametrize("cap,plan", [
    (1, ("scalar", True)), (3, ("scalar", True)), (4, ("loop", False)),
    (6, ("scalar", True)), (8, ("loop", False)), (16, ("loop", False)),
    (20, ("loop", True)), (32, ("loop", True)), (64, ("loop", True)),
    (260, ("loop", True))])
def test_probe32_plan_is_chosen_by_cap(cap, plan):
    """16-byte loads of the key row wherever C is a multiple of 4 and the
    planes are 16-byte aligned, lane by lane elsewhere; the fill counts
    read from C = 20 on (a key row longer than 64 bytes)."""
    got = hp.probe32_plan(cap)
    assert (got.design, got.counts) == plan
    assert hp.probe32_plan(cap, aligned=False).design == "scalar"
