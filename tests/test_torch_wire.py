"""The port's wire format (``repro_torch.core.wire``) and rank groups
(``repro_torch.core.comm``).

Packed buffers, header words and checksums are held byte for byte against
``repro.core.wire`` on the same numpy tables, for every lane mode, masked and
compact, narrow and wide.  ThreadGroup collectives are held against numpy
answers, and an error in one rank must come back to the caller instead of
hanging the others.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import relational as RR
from repro.core import table as RT
from repro.core import wire as RW

from repro_torch import kernels as K
from repro_torch.core import comm
from repro_torch.core import relational as rel
from repro_torch.core import table as T
from repro_torch.core import wire as W


def _cols(rng, n=80):
    return {
        "k64": rng.integers(0, 200, n).astype(np.int64),
        "wide64": rng.integers(0, 1 << 40, n).astype(np.int64),
        "mid64": rng.integers(100_000, 1 << 25, n).astype(np.int64),
        "neg64": rng.integers(-(1 << 45), -(1 << 44), n).astype(np.int64),
        "i32": rng.integers(-50, 900, n).astype(np.int32),
        "d16": rng.integers(8000, 10500, n).astype(np.int32),
        "f64": rng.normal(size=n),
        "f32": rng.normal(size=n).astype(np.float32),
        "b": rng.integers(0, 2, n).astype(bool),
        "c": np.full(n, -7, np.int64),
    }


def _bounds(cols):
    return {n: (int(v.min()), int(v.max())) for n, v in cols.items()
            if np.issubdtype(v.dtype, np.integer)}


def _tables(cols, cap, masked):
    """The same table in both engines (masked: a filter on k64)."""
    rt = RT.from_numpy(cols, capacity=cap)
    pt = T.from_numpy(cols, capacity=cap, device="cpu")
    if masked:
        rt = RR.filter_rows(rt, rt["k64"] < 150)
        pt = rel.filter_rows(pt, pt["k64"] < 150)
    return rt, pt


def _fmt(cols, bounds, narrow):
    return W.plan_wire_format(cols, {n: v.dtype for n, v in cols.items()},
                              bounds, narrow=narrow)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_pack_table_byte_identical(seed, narrow, masked):
    rng = np.random.default_rng(seed)
    cols = _cols(rng)
    rt, pt = _tables(cols, 96, masked)
    bounds = _bounds(cols)
    fmt = _fmt(cols, bounds, narrow)
    rfmt = RW.plan_wire_format(cols, {n: v.dtype for n, v in cols.items()},
                               bounds, narrow=narrow)
    assert dataclasses.astuple(fmt) == dataclasses.astuple(rfmt)
    if narrow:   # every lane mode is exercised
        assert {c.mode for c in fmt.cols} == {"lane8", "lane16", "u32",
                                              "word", "split", "const"}
    buf, overflow = W.pack_table(pt, fmt)
    rbuf, roverflow = RW.pack_table(rt, rfmt)
    assert buf.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    assert bool(overflow) == bool(roverflow) is False
    back = W.unpack_table(buf, fmt)
    rback = RW.unpack_table(rbuf, rfmt)
    m = pt.valid_mask().numpy()
    for name, v in cols.items():
        got = back[name].numpy()
        assert got.dtype == v.dtype, name
        np.testing.assert_array_equal(got, np.asarray(rback[name]),
                                      err_msg=name)
        np.testing.assert_array_equal(got[m], pt[name].numpy()[m],
                                      err_msg=name)


def test_split_word_order_matches_bitcast():
    """A float64 / int64 splits low word first, as the reference's
    ``bitcast_convert_type`` does."""
    x = np.array([1.5, -2.25e300, 0.0], np.float64)
    k = np.array([1, -1, (1 << 40) + 3], np.int64)
    import jax
    for v in (x, k):
        want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(v),
                                                       jnp.int32))
        got = torch.from_numpy(v).view(torch.int32).reshape(-1, 2).numpy()
        np.testing.assert_array_equal(got, want)


def test_lying_bounds_set_overflow():
    cols = _cols(np.random.default_rng(7))
    _, pt = _tables(cols, 96, masked=False)
    bounds = _bounds(cols)
    lo, hi = bounds["k64"]
    for lie in [(lo, max(lo, hi // 4)), (lo + 1, hi), (hi + 1, hi + 2)]:
        fmt = _fmt(cols, {**bounds, "k64": lie}, True)
        _, overflow = W.pack_table(pt, fmt)
        assert bool(overflow), lie


def test_lying_bounds_checked_on_valid_rows_only():
    cols = _cols(np.random.default_rng(8))
    _, pt = _tables(cols, 96, masked=True)
    m = pt.valid_mask().numpy()
    lo, hi = int(cols["k64"][m[:80]].min()), int(cols["k64"][m[:80]].max())
    fmt = _fmt(cols, {**_bounds(cols), "k64": (lo, hi)}, True)
    _, overflow = W.pack_table(pt, fmt)
    assert not bool(overflow)


# ---------------------------------------------------------------------------
# checksum and header words
# ---------------------------------------------------------------------------

def _payload(seed, rows=40, words=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (rows, words)).astype(np.int32)


@pytest.mark.parametrize("mode,words", [("word", 3), ("folded", 1)])
def test_header_words_equal_reference(mode, words):
    pay = _payload(1, words=words)
    csum = W.payload_checksum(torch.from_numpy(pay))
    rcsum = RW.payload_checksum(jnp.asarray(pay))
    assert int(csum) == int(rcsum)
    for count in (0, 1, 39, 40, 65535):
        c = torch.tensor(count, dtype=torch.int32)
        rc = jnp.asarray(count, jnp.int32)
        w0 = W.encode_header_word0(c, csum, mode)
        assert int(w0) == int(RW.encode_header_word0(rc, rcsum, mode))
        assert int(W.decode_header_word0(w0, mode)) == count
        assert int(W.encode_checksum_word(c, csum)) == \
            int(RW.encode_checksum_word(rc, rcsum))
        assert int(W.fold16(csum)) == int(RW.fold16(rcsum))


def test_checksum_batched_equals_per_block():
    blocks = np.stack([_payload(s) for s in range(5)])
    got = W.payload_checksum(torch.from_numpy(blocks))
    for i in range(5):
        assert int(got[i]) == int(RW.payload_checksum(jnp.asarray(blocks[i])))


def _block(pay, mode):
    """Header row + payload, as a sender builds it."""
    count = torch.tensor(pay.shape[0] - 3, dtype=torch.int32)
    p = torch.from_numpy(pay)
    csum = W.payload_checksum(p)
    hdr = torch.zeros(pay.shape[1], dtype=torch.int32)
    hdr[0] = W.encode_header_word0(count, csum, mode)
    if mode == "word":
        hdr[1] = W.encode_checksum_word(count, csum)
    return hdr, p


@pytest.mark.parametrize("mode,words", [("word", 3), ("folded", 1)])
def test_single_bit_flip_sweep_always_caught(mode, words):
    """Every single bit of a packed block — payload and header — flipped in
    turn: verification fails each time, and the reference agrees."""
    pay = _payload(2, rows=12, words=words)
    hdr, p = _block(pay, mode)
    assert not bool(W.verify_block_checksum(hdr, p, mode))
    full = torch.cat([hdr[None, :], p]).numpy()
    for w in range(full.size):
        for bit in range(32):
            f = full.copy().reshape(-1)
            f.view(np.uint32)[w] ^= np.uint32(1 << bit)
            f = f.reshape(full.shape)
            bad = W.verify_block_checksum(torch.from_numpy(f[0]),
                                          torch.from_numpy(f[1:]), mode)
            assert bool(bad), (w, bit)
    # the reference's verdict on a sample of the same flips
    for w, bit in [(0, 0), (1, 31), (full.size - 1, 7)]:
        f = full.copy().reshape(-1)
        f.view(np.uint32)[w] ^= np.uint32(1 << bit)
        f = f.reshape(full.shape)
        assert bool(RW.verify_block_checksum(jnp.asarray(f[0]),
                                             jnp.asarray(f[1:]), mode))


def test_header_mode_none_ships_unchecked():
    assert W.header_mode(1, 1 << 16) == "none"
    hdr, p = _block(_payload(3, words=1), "folded")
    assert not bool(W.verify_block_checksum(hdr, p, "none"))


# ---------------------------------------------------------------------------
# ThreadGroup collectives
# ---------------------------------------------------------------------------

def test_thread_group_collectives_equal_numpy():
    n = 4
    rng = np.random.default_rng(0)
    data = rng.integers(-1000, 1000, (n, n, 3, 2)).astype(np.int64)
    vals = rng.normal(size=n)

    def body(g):
        x = torch.from_numpy(data[g.rank])
        v = torch.tensor(vals[g.rank])
        return (g.all_to_all(x).numpy(), g.all_gather(x).numpy(),
                {op: float(g.all_reduce(v, op)) for op in ("sum", "min",
                                                            "max")},
                g.ppermute(x, [(i, (i + 1) % n) for i in range(n)]).numpy(),
                g.ppermute(x, [(0, 2)]).numpy())

    out = comm.ThreadGroup(n, "cpu").run(body)
    assert len(out) == n
    for r, (a2a, ag, red, ring, one) in enumerate(out):
        np.testing.assert_array_equal(a2a, data[:, r])
        np.testing.assert_array_equal(ag, data)
        assert red["sum"] == ((vals[0] + vals[1]) + vals[2]) + vals[3]
        assert red["min"] == vals.min() and red["max"] == vals.max()
        np.testing.assert_array_equal(ring, data[(r - 1) % n])
        np.testing.assert_array_equal(
            one, data[0] if r == 2 else np.zeros_like(data[0]))


def test_thread_group_reraises_a_rank_error():
    """Rank 2 fails before a collective the others wait at: the barrier is
    aborted and the caller sees rank 2's error, well inside the timeout."""
    class Boom(RuntimeError):
        pass

    def body(g):
        x = torch.ones(3)
        g.all_gather(x)
        if g.rank == 2:
            raise Boom("rank 2")
        return g.all_gather(x)

    result = {}

    def caller():
        try:
            comm.ThreadGroup(4, "cpu").run(body)
        except BaseException as e:   # noqa: BLE001 — inspected below
            result["error"] = e

    t = threading.Thread(target=caller, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the group hung after a rank failed"
    assert isinstance(result.get("error"), Boom)


def test_thread_group_times_out_a_missing_rank(monkeypatch):
    monkeypatch.setattr(comm, "BARRIER_TIMEOUT_S", 0.5)

    def body(g):
        if g.rank == 0:
            return None          # never reaches the collective
        return g.all_gather(torch.ones(1))

    with pytest.raises(TimeoutError):
        comm.ThreadGroup(3, "cpu").run(body)


def test_launch_counter_is_thread_safe(monkeypatch):
    """Eight threads count launches at once with a short switch interval: no
    increment is lost."""
    monkeypatch.setattr(K, "launches", dict.fromkeys(K.KERNELS, 0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(g):
            for _ in range(5000):
                K.count_launch("counting_rank")
        comm.ThreadGroup(8, "cpu").run(body)
    finally:
        sys.setswitchinterval(old)
    assert K.launches["counting_rank"] == 8 * 5000
