"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: on a machine without CUDA each test skips with a reason
(decided inside the fixture, never at import, so every test worker collects
the same tests).  On a machine with an H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the main path's full shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import backend as B
from repro_torch.core import relational as rel
from repro_torch.configs import get_config
from repro_torch.core.sortcount import LEGS, MAX_SORTS, SortCounter
from repro_torch.core.table import from_numpy
from repro_torch.data import tpch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.hash_group import ops as hg
from repro_torch.kernels.hash_group import ref as hg_ref
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.radix_hist import ops as rh
from repro_torch.kernels.radix_hist import ref as rh_ref
from repro_torch.kernels.segsum import ops as ss
from repro_torch.kernels.segsum import ref as ss_ref
from repro_torch.launch import serve_lm
from repro_torch.models import Model
from repro_torch.queries import QUERIES

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    return torch.device("cuda:0")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("groups", [1, 255, 8193])
def test_segsum_kernel_vs_plain(cuda, dtype, groups):
    g = torch.Generator(device=cuda).manual_seed(groups)
    n = 200_003
    gids = torch.randint(-2, groups + 3, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    v = (torch.randn((n, 5), generator=g, device=cuda) * 1000).to(dtype)
    for op in ("sum", "min", "max"):
        got = ss.segment_reduce(gids, v, groups, op)
        want = ss_ref.segment_reduce_ref(gids, v, groups, op)
        if dtype.is_floating_point and op == "sum":
            rtol = 1e-9 if dtype == torch.float64 else 1e-4
            torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * 1e3)
        else:
            assert torch.equal(got, want), op
    cnt = ss.segment_reduce(gids, None, groups, "count")
    assert torch.equal(cnt, ss_ref.segment_reduce_ref(
        gids, torch.ones((n, 1), dtype=torch.int64, device=cuda), groups,
        "sum")[:, 0])
    again = ss.segment_reduce(gids, v, groups, "sum")
    assert torch.equal(again, ss.segment_reduce(gids, v, groups, "sum"))


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.parametrize("groups,ncols", [(8, 5), (1, 1), (2049, 2),
                                          (8193, 3)])
def test_segsum_float64_sums_identical_across_calls_and_offsets(
        cuda, groups, ncols):
    """Several million rows in every float regime: the same bits on every
    call, and for ids and values at another storage offset (so another
    alignment), and within 1e-9 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(groups)
    n = 3_000_017
    gids = torch.randint(0, groups + 1, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn((n, ncols), generator=g, device=cuda,
                       dtype=torch.float64) * 1e4
    out = ss.segment_reduce(gids, vals, groups, "sum")
    assert torch.equal(_bits(out), _bits(ss.segment_reduce(gids, vals, groups,
                                                           "sum")))
    gbuf = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    vbuf = torch.empty(n * ncols + 1, dtype=torch.float64, device=cuda)
    gbuf[1:].copy_(gids)
    vbuf[1:].copy_(vals.reshape(-1))
    shifted = ss.segment_reduce(gbuf[1:], vbuf[1:].view(n, ncols), groups,
                                "sum")
    assert torch.equal(_bits(out), _bits(shifted))
    want = ss_ref.segment_reduce_ref(gids, vals, groups, "sum")
    scale = want.abs().max().item()
    torch.testing.assert_close(out, want, rtol=1e-9, atol=1e-9 * scale)


def test_segsum_float64_sums_identical_beside_a_concurrent_stream(cuda):
    """Another kernel busy on a second stream changes which blocks run when,
    never the bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    n, groups = 4_000_000, 2049
    gids = torch.randint(0, groups + 1, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn((n, 2), generator=g, device=cuda,
                       dtype=torch.float64) * 1e4
    alone = ss.segment_reduce(gids, vals, groups, "sum")
    a = torch.randn((4096, 4096), generator=g, device=cuda)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    outs = []
    with torch.cuda.stream(side):
        for _ in range(8):
            a = a @ a / 64.0
    for _ in range(3):
        outs.append(ss.segment_reduce(gids, vals, groups, "sum"))
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(_bits(o), _bits(alone))


@pytest.mark.parametrize("groups", [1, 8, 2049, 8193, 40_000])
def test_segsum_integer_sums_and_counts_exact(cuda, groups):
    """Atomics, exact: int32 (wrapping) and int64 sums over 1, 2 and 5
    columns and the count, with ids outside [0, groups), for tiles in one
    copy a warp (1, 8), a few copies a block (2049, 8193) and none (40000:
    straight into the output)."""
    g = torch.Generator(device=cuda).manual_seed(groups)
    n = 2_000_003
    gids = torch.randint(-2, groups + 3, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    K.reset_launches()
    cnt = ss.segment_reduce(gids, None, groups, "count")
    assert K.launches["segsum_count"] == K.launches["segsum_sum"] == 1
    ones = torch.ones((n, 1), dtype=torch.int64, device=cuda)
    assert torch.equal(cnt, ss_ref.segment_reduce_ref(gids, ones, groups,
                                                      "sum")[:, 0])
    for dtype, hi in ((torch.int32, 2**31 - 1), (torch.int64, 2**62)):
        for ncols in (1, 2, 5):
            v = torch.randint(-hi, hi, (n, ncols), generator=g, device=cuda,
                              dtype=dtype)
            got = ss.segment_reduce(gids, v, groups, "sum")
            assert torch.equal(got, ss_ref.segment_reduce_ref(gids, v, groups,
                                                              "sum"))
    assert K.launches["segsum_count"] == 1


@pytest.mark.parametrize("cap,distinct", [(16, 9), (512, 40), (64, 200)])
def test_hash_insert_kernel_vs_plain(cuda, cap, distinct):
    g = torch.Generator(device=cuda).manual_seed(cap)
    pool = torch.randint(-2**62, 2**62, (distinct,), generator=g, device=cuda)
    keys = pool[torch.randint(0, distinct, (100_000,), generator=g,
                              device=cuda)]
    valid = torch.rand(keys.shape[0], generator=g, device=cuda) < 0.8
    slot, dk, occ, unres = hg.build_group_dict(keys, valid, cap)
    pslot, pdk, pocc, punres = hg_ref.hash_insert_ref(
        keys, valid, cap, hg.default_rounds(cap))
    assert bool(unres) == bool(punres) == (distinct > cap)
    if not bool(unres):
        def dense(s, d, o):
            r = hg.dict_rank(d, o)
            return torch.where(s >= 0, r[s.clamp(min=0).long()], -1)
        assert torch.equal(dense(slot, dk, occ), dense(pslot, pdk, pocc))


# (cap, distinct keys, shape of the draw): a third of the rows on one key
# ("dominant", as Q13's customers without orders), that key INT64_MIN (the
# shared design's empty marker, so those rows take the global probe), one
# key for every row, and more keys than slots (unresolved)
_INSERT_CASES = {"cap16": (16, 9, None), "cap512": (512, 40, None),
                 "cap8192": (8192, 3000, None), "overflow": (64, 200, None),
                 "dominant": (512, 40, "dominant"),
                 "int64_min": (512, 40, "int64_min"), "pool1": (512, 1, None)}


@pytest.mark.parametrize("design", ["shared", "global"])
@pytest.mark.parametrize("case", sorted(_INSERT_CASES))
def test_hash_insert_designs_vs_plain(cuda, monkeypatch, design, case):
    """Both designs against the plain version: the unresolved flag, and
    where every row was placed the dense ids and the key set; a placed row's
    slot always holds its key."""
    cap, distinct, shape = _INSERT_CASES[case]
    monkeypatch.setattr(hg, "insert_design", lambda cap: design)
    g = torch.Generator(device=cuda).manual_seed(cap + distinct)
    n = 300_000
    pool = torch.randint(-2**62, 2**62, (distinct,), generator=g, device=cuda)
    keys = pool[torch.randint(0, distinct, (n,), generator=g, device=cuda)]
    third = torch.rand(n, generator=g, device=cuda) < 1 / 3
    if shape == "dominant":
        keys = torch.where(third, 0, keys)
    elif shape == "int64_min":
        keys = torch.where(third, torch.iinfo(torch.int64).min, keys)
    valid = torch.rand(n, generator=g, device=cuda) < 0.8
    K.reset_launches()
    slot, dk, occ, unres = hg.build_group_dict(keys, valid, cap)
    torch.cuda.synchronize()
    assert K.launches["hash_insert"] == 1
    pslot, pdk, pocc, punres = hg_ref.hash_insert_ref(
        keys, valid, cap, hg.default_rounds(cap))
    assert bool(unres) == bool(punres) == (distinct > cap)
    placed = slot >= 0
    assert torch.equal(dk[slot[placed].long()], keys[placed])
    assert bool(occ[slot[placed].long()].all())
    assert bool(unres) == bool((valid & ~placed).any())
    if not bool(unres):
        def dense(s, d, o):
            r = hg.dict_rank(d, o)
            return torch.where(s >= 0, r[s.clamp(min=0).long()], -1)
        assert torch.equal(dense(slot, dk, occ), dense(pslot, pdk, pocc))
        assert torch.equal(torch.sort(dk[occ]).values,
                           torch.sort(pdk[pocc]).values)


@pytest.mark.parametrize("design", ["shared", "global"])
def test_hash_insert_designs_no_rows_and_no_valid_rows(cuda, monkeypatch,
                                                       design):
    monkeypatch.setattr(hg, "insert_design", lambda cap: design)
    for n in (0, 5000):
        keys = torch.arange(n, dtype=torch.int64, device=cuda) - 7
        valid = torch.zeros(n, dtype=torch.bool, device=cuda)
        slot, dk, occ, unres = hg.build_group_dict(keys, valid, 64)
        assert slot.shape == (n,) and bool((slot == -1).all())
        assert not bool(occ.any()) and not bool(unres)
        assert not bool(dk.any())


@pytest.mark.parametrize("cap", [16, 6])
def test_hash_probe_kernel_vs_plain(cuda, cap):
    """Negative keys at about 1.5 keys a bucket; at cap 6 a few buckets
    overflow and their keys past the cap must miss, as in the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    m = 100_000
    build = torch.randperm(m, generator=g, device=cuda) - m // 2
    rows = torch.arange(m, dtype=torch.int32, device=cuda)
    table = hp.build_bucket_table64(build, rows, hp.next_pow2(2 * m) // 4,
                                    cap=cap)
    probe = torch.randint(-m, m, (300_000,), generator=g, device=cuda)
    K.reset_launches()
    got = hp.hash_probe64(probe, *table[:2])
    torch.cuda.synchronize()
    assert K.launches["hash_probe64"] == 1
    assert torch.equal(got, hp_ref.hash_probe64_ref(probe, *table[:2]))


@pytest.mark.parametrize("cap", [16, 6])
@pytest.mark.parametrize("keys_a_bucket", [1.5, 12])
def test_hash_probe_kernel_vs_plain_duplicates_invalid_overflow(
        cuda, cap, keys_a_bucket):
    """Wide negative keys, duplicate build keys (the first row wins),
    invalid build rows (never found) and, at 12 keys a bucket, an
    overflowed build whose truncated buckets the kernel walks as the plain
    version does; found rows hold the probed key."""
    g = torch.Generator(device=cuda).manual_seed(cap)
    m = 200_000
    build = torch.randint(-2**62, 2**62, (m,), generator=g, device=cuda)
    build[:1000] = build[1000:2000]                      # duplicates
    valid = torch.rand(m, generator=g, device=cuda) < 0.9
    rows = torch.randperm(m, generator=g, device=cuda).to(torch.int32)
    buckets = max(128, int(m / keys_a_bucket))
    heads, tails, ov = hp.build_bucket_table64(build, rows, buckets,
                                               cap=cap, valid=valid)
    lo, hi = hp.split64(torch.unique(build[valid]))
    per_bucket = torch.bincount(hp.bucket_of(lo, hi, buckets),
                                minlength=buckets)
    assert bool(ov) == bool((per_bucket > cap).any())
    if keys_a_bucket > cap:
        assert bool(ov)
    probe = torch.cat([build, torch.randint(-2**62, 2**62, (100_000,),
                                            generator=g, device=cuda)])
    got = hp.hash_probe64(probe, heads, tails)
    assert torch.equal(got, hp_ref.hash_probe64_ref(probe, heads, tails))
    hit = got >= 0
    assert torch.equal(build[torch.argsort(rows)[got[hit].long()]],
                       probe[hit])
    assert not bool(hit[:m][~valid & ~torch.isin(build, build[valid])].any())


def test_queries_on_card_launch_every_kernel(cuda):
    db = tpch.generate(0.01, seed=11)
    K.reset_launches()
    for jm in ("sorted", "hash"):
        for qid in sorted(QUERIES):
            got, _ = B.run_local(QUERIES[qid], db, join_method=jm)
            want, _ = B.run_reference(QUERIES[qid], db)
            for k in want:
                np.testing.assert_allclose(
                    np.asarray(got[k], dtype=np.float64),
                    np.asarray(want[k], dtype=np.float64), rtol=1e-7)
    # the kernels of run_local's path; the counting rank and the histogram
    # run on the distributed and skew-statistics paths
    local = ("segsum_sum", "segsum_count", "segsum_minmax", "hash_insert",
             "hash_probe64")
    assert all(K.launches[k] > 0 for k in local), K.launches


def test_sort_counts_on_card_equal_the_cpu_counts(cuda):
    """The 22 local plans at sf 0.005, sorted joins, planner on: the card
    takes exactly the sorts the CPU path takes (the kernels sort nothing),
    and those are the budgets of ``sortcount.MAX_SORTS``."""
    db = tpch.generate(0.005, seed=11)
    counts = {}
    for dev in ("cpu", cuda):
        for qid in sorted(QUERIES):
            with SortCounter() as c:
                B.run_local(QUERIES[qid].with_inference(True), db,
                            join_method="sorted", device=dev)
            counts.setdefault(qid, []).append(len(c.calls))
    assert all(cpu == card for cpu, card in counts.values()), counts
    on = LEGS.index(("sorted", True))
    assert {q: c[0] for q, c in counts.items()} == \
        {q: b[on] for q, b in MAX_SORTS.items()}


@pytest.mark.parametrize("n", [1, 4095, 4096, 300_001])
@pytest.mark.parametrize("parts", [5, 9, 129, 4096])
def test_counting_rank_kernel_vs_plain(cuda, n, parts):
    """Exact: the slots a stable sort by key would give, for tiles that end
    mid-chunk and widths that fill the rank pass's shared memory."""
    g = torch.Generator(device=cuda).manual_seed(n + parts)
    keys = torch.randint(0, parts, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    slot, counts = rh.counting_rank(keys, parts)
    want_slot, want_counts = rh_ref.counting_rank_ref(keys, parts)
    assert torch.equal(slot, want_slot)
    assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("n", [4097, 1_000_003, 6_000_000])
@pytest.mark.parametrize("parts", [1, 5, 9, 31, 32, 63])
def test_counting_rank_exact_on_both_sides_of_the_single_pass_width(
        cuda, n, parts):
    """Many tiles, widths up to 32 (single pass) and above (three passes);
    the call is counted once, and under counting_rank_onepass only when the
    single-pass kernel ran it."""
    g = torch.Generator(device=cuda).manual_seed(n + parts)
    keys = torch.randint(0, parts, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    K.reset_launches()
    slot, counts = rh.counting_rank(keys, parts)
    single = parts + 1 <= 32
    assert K.launches["counting_rank"] == 1
    assert K.launches["counting_rank_onepass"] == int(single)
    want_slot, want_counts = rh_ref.counting_rank_ref(keys, parts)
    assert torch.equal(slot, want_slot)
    assert torch.equal(counts, want_counts)
    assert rh.rank_design(parts + 1) == \
        ("single_pass" if single else "three_pass")


@pytest.mark.parametrize("parts", [63, 129])
def test_counting_rank_three_pass_on_misaligned_keys(cuda, parts):
    """keys[1:] is not 16-byte aligned: the tiles' histograms (pass 1, the
    partition histogram's kernel) load it lane by lane."""
    g = torch.Generator(device=cuda).manual_seed(parts)
    keys = torch.randint(0, parts, (1_000_004,), generator=g, device=cuda,
                         dtype=torch.int32)[1:]
    slot, counts = rh.counting_rank(keys, parts)
    want_slot, want_counts = rh_ref.counting_rank_ref(keys, parts)
    assert torch.equal(slot, want_slot)
    assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("parts", [5, 9, 63])
def test_counting_rank_repeated_and_on_two_streams(cuda, parts):
    """Back-to-back calls, and calls on two streams at once, each give the
    solo result: no call finds another's look-back words or ticket."""
    g = torch.Generator(device=cuda).manual_seed(parts)
    keys = [torch.randint(0, parts, (n,), generator=g, device=cuda,
                          dtype=torch.int32) for n in (3_000_001, 2_500_000)]
    solo = [rh.counting_rank(k, parts) for k in keys]
    for _ in range(3):
        for k, want in zip(keys, solo):
            got = rh.counting_rank(k, parts)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    streams = [torch.cuda.Stream(device=cuda) for _ in keys]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(4):
        for i, (s, k) in enumerate(zip(streams, keys)):
            with torch.cuda.stream(s):
                outs[i].append(rh.counting_rank(k, parts))
    torch.cuda.synchronize()
    for i, want in enumerate(solo):
        for got in outs[i]:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 3, 2047, 2048, 2049, 300_001])
@pytest.mark.parametrize("parts", [1, 8, 31, 32, 33, 64, 129, 12288])
@pytest.mark.parametrize("hashed", [True, False])
def test_radix_hist_kernel_vs_plain(cuda, n, parts, hashed):
    """Widths that are powers of two (the bin a mask) and not (the
    multiply-high modulo), on both sides of 32 and up to the width limit:
    exact, and the same bytes twice."""
    g = torch.Generator(device=cuda).manual_seed(n)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    got = rh.radix_hist(keys, parts, hashed=hashed)
    want = rh.radix_hist(keys.cpu(), parts, hashed=hashed)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rh.radix_hist(keys, parts, hashed=hashed), got)


@pytest.mark.parametrize("blk", [8, 100, 102, 2048, 5000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("parts", [8, 64])
def test_radix_hist_blocks_and_misaligned_keys(cuda, blk, offset, parts):
    """Blocks smaller than, not a multiple of 4 and larger than a chunk of
    2048 rows, and keys[1:] (not 16-byte aligned: loaded lane by lane)."""
    g = torch.Generator(device=cuda).manual_seed(blk + offset)
    base = torch.randint(-2**31, 2**31 - 1, (300_002,), generator=g,
                         device=cuda, dtype=torch.int32)
    keys = base[offset:offset + 300_001]
    assert rh.hist_plan(keys.shape[0], parts, blk,
                        keys.data_ptr() % 16 == 0).vector == \
        (offset == 0 and blk % 4 == 0)
    for hashed in (True, False):
        got = rh.radix_hist(keys, parts, blk=blk, hashed=hashed)
        want = rh_ref.radix_hist_plain(keys.cpu(), parts, blk, hashed=hashed)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("parts", [8, 64, 4096])
def test_radix_hist_one_hot_bin(cuda, parts):
    """Every key in one bin: the count of each block lands in one column."""
    keys = torch.full((1_000_003,), 12345, dtype=torch.int32, device=cuda)
    for hashed in (True, False):
        got = rh.radix_hist(keys, parts, hashed=hashed)
        want = rh_ref.radix_hist_plain(keys.cpu(), parts, 2048,
                                       hashed=hashed)
        assert torch.equal(got.cpu(), want)
        assert int((got.sum(dim=0) > 0).sum()) == 1


@pytest.mark.parametrize("qid", [3, 10])
def test_run_distributed_on_card(cuda, qid):
    db = tpch.generate(0.01, seed=11)
    K.reset_launches()
    got, stats, overflow = B.run_distributed(QUERIES[qid], db, 2)
    assert not overflow
    assert stats.counts() == QUERIES[qid].static_counts()
    want, _ = B.run_reference(QUERIES[qid], db)
    for k in want:
        assert len(got[k]) == len(want[k])
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(want[k], dtype=np.float64),
                                   rtol=1e-7)
    # every shuffle's dispatch ranks its rows with the single-pass kernel
    assert (K.launches["counting_rank"] > 0) == (stats.shuffles > 0)
    assert K.launches["counting_rank_onepass"] == K.launches["counting_rank"]


def test_sort_path_float_sum_is_deterministic(cuda):
    """The sort path's float sums give the same bits on every call (float
    atomics would not: narrow and wide wire runs of Q10 then differ)."""
    rng = np.random.default_rng(0)
    n = 2_000_000
    t = from_numpy({"k": rng.integers(0, n // 3, n),
                    "v": rng.normal(size=n) * 1e6}, device=cuda)
    outs = [rel.group_aggregate(t, ["k"], [("s", "sum", "v")],
                                method="sort")["s"] for _ in range(3)]
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int64), outs[0].view(torch.int64))


@pytest.mark.parametrize("qid", [9, 10, 13, 18])
def test_distributed_narrow_equals_wide_on_card(cuda, qid):
    db = tpch.generate(0.05, seed=11)
    narrow, _, _ = B.run_distributed(QUERIES[qid], db, 4)
    wide, _, _ = B.run_distributed(QUERIES[qid], db, 4, wire_format="wide")
    for k in narrow:
        assert narrow[k].tobytes() == wide[k].tobytes(), k


@pytest.mark.parametrize("qid", [5, 9, 13])
def test_tampered_exchange_on_card_raises_and_recovers(cuda, qid):
    """A corrupt fault flips one bit of a checksummed exchange's received
    buffer on the card: the run raises CorruptPayload, and the runner's
    wide re-run returns the clean wide answer byte for byte."""
    from repro_torch.core import wire as W
    from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                               FaultSpec)
    from repro_torch.distributed.fault import QueryRunner
    db = tpch.generate(0.05, seed=11)
    plan = FaultPlan(9, (FaultSpec("corrupt", cut="group_by"),))
    with pytest.raises(W.CorruptPayload):
        B.run_distributed(QUERIES[qid], db, 4, chaos=ChaosInjector(plan))
    inj = ChaosInjector(plan)
    res = QueryRunner(db, 4, chaos=inj).run(QUERIES[qid])
    assert res.report.outcomes() == ["corrupt", "ok"]
    assert not inj.events[0].simulated
    clean, _, _ = B.run_distributed(QUERIES[qid], db, 4, wire_format="wide")
    for k in clean:
        assert clean[k].tobytes() == res.result[k].tobytes(), k


@pytest.mark.parametrize("qid", [5, 9, 18])
def test_device_loss_on_card_equals_a_clean_smaller_group(cuda, qid):
    from repro_torch.distributed.chaos import ChaosInjector, FaultPlan
    from repro_torch.distributed.fault import QueryRunner
    db = tpch.generate(0.05, seed=11)
    runner = QueryRunner(db, 4, chaos=ChaosInjector(
        FaultPlan.device_loss(11, devices=(3,), cut="exchange")))
    res = runner.run(QUERIES[qid])
    assert res.report.outcomes() == ["device_lost", "ok"]
    assert (runner.devices, runner.topology_generation) == (3, 1)
    widths = {key[1] for key in db.__dict__[B._DEVICE_SHARDS]}
    assert widths == {3}                      # the 4-rank shards were freed
    clean, _, _ = B.run_distributed(QUERIES[qid], db, 3)
    for k in clean:
        assert clean[k].tobytes() == res.result[k].tobytes(), k


@pytest.mark.parametrize("qid", [5, 9, 18])
def test_lineage_resume_on_card(cuda, tmp_path, qid):
    from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                               FaultSpec, TransientFault)
    from repro_torch.distributed.lineage import LineageStore, run_resumable
    db = tpch.generate(0.05, seed=11)
    clean, _ = B.run_local(QUERIES[qid], db)
    for n_from, n_to in ((1, 1), (8, 5)):
        store = LineageStore(str(tmp_path / f"lin{n_from}"))
        inj = ChaosInjector(FaultPlan(qid, (
            FaultSpec("transient", cut="finalize"),)))
        with pytest.raises(TransientFault):
            run_resumable(QUERIES[qid], db, store, chaos=inj,
                          n_devices=n_from)
        assert store.saved >= 1
        got, _, ov, reused = run_resumable(QUERIES[qid], db, store,
                                           n_devices=n_to)
        assert not ov and reused >= 1
        assert (store.resharded >= 1) == (n_from != n_to)
        for k in clean:
            assert clean[k].tobytes() == got[k].tobytes(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_kernel_vs_plain(cuda, monkeypatch, d, causal, group,
                                         dtype):
    """Every head size, both masks, GQA groups 1 and 4, a ragged sequence
    (200 rows: the last query and key tiles are partial) and Sq < Skv.
    float32 within 1e-5 of the plain version (same arithmetic, another
    order); bf16 within one output rounding element by element: each side
    rounds its float32 result to bf16 once (unit roundoff 2^-8, so 2^-7 of
    |want| between them, rtol 8e-3), plus the float32 tolerance near zero
    (atol 2e-5), and within 2e-2 max abs on unit-normal inputs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(d + group)
    for sq, skv in ((200, 200), (72, 200)):
        q = torch.randn((2, 2 * group, sq, d), generator=g, device=cuda)
        k = torch.randn((2, 2, skv, d), generator=g, device=cuda)
        v = torch.randn((2, 2, skv, d), generator=g, device=cuda)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        K.reset_launches()
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert K.launches["flash_attention"] == 1
        want = fa_ref.attention_ref(q.reshape(-1, sq, d),
                                    k.reshape(-1, skv, d),
                                    v.reshape(-1, skv, d),
                                    causal=causal).reshape(got.shape)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=8e-3, atol=2e-5)
            assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_flash_attention_kernel_refuses(cuda):
    q = torch.zeros((1, 2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


# the element-wise bf16 limit of chip_smoke.py: each side rounds its float32
# result to bf16 once (2^-7 of |want| between them) plus the float32
# tolerance near zero
_BF16_RTOL, _BF16_ATOL = 8e-3, 2e-5


def _excess(got, want):
    """Largest |got - want| - (atol + rtol |want|): at most 0 passes."""
    want = want.float()
    return ((got.float() - want).abs() - _BF16_RTOL * want.abs()
            - _BF16_ATOL).max().item()


def _flash_case(q, k, v, causal):
    """The kernel's output and the plain version's, (B, H, S, D) inputs."""
    b, hq, sq, d = q.shape
    K.reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == 1
    assert K.launches["flash_attention_wgmma"] == 1
    want = fa_ref.attention_ref(q.reshape(b * hq, sq, d),
                                k.reshape(-1, k.shape[2], d),
                                v.reshape(-1, v.shape[2], d),
                                causal=causal).reshape(got.shape)
    return got, want


@pytest.mark.parametrize("sq,skv", [(1000, 1000), (4097, 4097), (300, 1000)])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_flash_attention_wgmma_vs_plain(cuda, monkeypatch, d, causal, group,
                                        sq, skv):
    """The tensor-core design at each head size it takes, both masks, GQA
    groups 1/3/4/8 (3 is Granite-MoE's 24/8), sequences that end inside a
    tile and Sq < Skv: within one bf16 output rounding of the plain version
    element by element."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert fa.design(torch.bfloat16, d) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(d + group + sq)
    q = torch.randn((1, group, sq, d), generator=g, device=cuda)
    k = torch.randn((1, 1, skv, d), generator=g, device=cuda)
    v = torch.randn((1, 1, skv, d), generator=g, device=cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got, want = _flash_case(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _excess(got, want) <= 0
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def _single_rounded_p(q, k, v, causal):
    """Attention whose P is rounded to bf16 once before the P.V product
    (float32 otherwise): the textbook tensor-core design."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / d ** 0.5
    if causal:
        qi = torch.arange(s.shape[1], device=s.device)[:, None]
        ki = torch.arange(s.shape[2], device=s.device)[None, :]
        s = torch.where(qi >= ki, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(), v.float())
    return (o / p.sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_flash_attention_wgmma_where_v_cancels(cuda, monkeypatch, d, causal):
    """Values alternate in sign over keys whose scores change smoothly, so
    every output is a small difference of large sums.  P rounded to bf16
    once lands outside one output rounding of the plain version there; the
    kernel's P_hi + P_lo does not."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    s = 1000
    g = torch.Generator().manual_seed(d)
    q = torch.randn((1, 1, s, d), generator=g)
    drift = torch.arange(s, dtype=torch.float32)[:, None] / s
    k = torch.randn((1, d), generator=g) + drift * 3.0 * torch.randn((1, d),
                                                                   generator=g)
    sign = 1.0 - 2.0 * (torch.arange(s) % 2).float()[:, None]
    v = sign * torch.randn((1, d), generator=g)
    q, k, v = (t.reshape(1, 1, s, d).to(torch.bfloat16).to(cuda)
               for t in (q, k, v))
    got, want = _flash_case(q, k, v, causal)
    once = _single_rounded_p(q[0], k[0], v[0], causal)[None]
    assert _excess(once, want) > 1e-4        # the trap the design avoids
    assert _excess(got, want) <= 0


@pytest.mark.parametrize("cap", [8, 5])
def test_hash_probe32_kernel_vs_plain(cuda, cap):
    """Bit for bit, with duplicate build keys and SENTINEL probes, on a
    table that overflowed (about 3 keys a bucket on average, so some buckets
    drop keys at cap 8 and more at cap 5); cap 5 is no multiple of the
    unrolled lane loop."""
    g = torch.Generator(device=cuda).manual_seed(cap)
    m = 200_000
    build = torch.randint(-2**31, 2**31 - 1, (m,), generator=g, device=cuda,
                          dtype=torch.int32)
    build[:100] = build[100:200]                       # duplicates
    rows = torch.randperm(m, generator=g, device=cuda).to(torch.int32)
    bkeys, bvals, _ = hp.build_bucket_table(build, rows,
                                            hp.next_pow2(2 * m) // 8, cap)
    probe = torch.cat([build[torch.randint(0, m, (300_000,), generator=g,
                                           device=cuda)],
                       torch.randint(-2**31, 2**31 - 1, (100_000,),
                                     generator=g, device=cuda,
                                     dtype=torch.int32),
                       torch.full((7,), hp.SENTINEL, dtype=torch.int32,
                                  device=cuda)])
    K.reset_launches()
    got = hp.hash_probe32(probe, bkeys, bvals)
    torch.cuda.synchronize()
    assert K.launches["hash_probe32"] == 1
    assert torch.equal(got, hp_ref.hash_probe32_ref(probe, bkeys, bvals))


@pytest.mark.parametrize("cap", [1, 3, 6, 8, 16, 32, 64])
def test_hash_probe32_designs_vs_plain(cuda, monkeypatch, cap):
    """Both designs (the loop where C is a multiple of 4), each reading and
    not reading the fill counts, given and not given, bit for bit against
    the plain version; duplicate build keys, SENTINEL as a build key and as
    a probe, rows equal to -1, buckets that overflowed.  Then a plane that
    is not 16-byte aligned, which the plan sends to the scalar design."""
    g = torch.Generator(device=cuda).manual_seed(cap)
    m = 50_000
    build = torch.randint(-2**31, 2**31 - 1, (m,), generator=g, device=cuda,
                          dtype=torch.int32)
    build[:100] = build[100:200]                       # duplicates
    build[300] = hp.SENTINEL
    rows = torch.randperm(m, generator=g, device=cuda).to(torch.int32)
    rows[400:450] = -1
    buckets = max(128, hp.next_pow2(2 * m) // max(cap, 4))
    bkeys, bvals, fill, _ = hp._bucket_table(build, rows, buckets, cap)
    probe = torch.cat([build[torch.randint(0, m, (200_000,), generator=g,
                                           device=cuda)],
                       torch.randint(-2**31, 2**31 - 1, (50_000,),
                                     generator=g, device=cuda,
                                     dtype=torch.int32),
                       torch.full((7,), hp.SENTINEL, dtype=torch.int32,
                                  device=cuda)])
    want = hp_ref.hash_probe32_ref(probe, bkeys, bvals)
    assert torch.equal(want, hp_ref.hash_probe32_ref(probe, bkeys, bvals,
                                                     fill))
    designs = ("scalar", "loop") if cap % 4 == 0 else ("scalar",)
    plans = [hp.Probe32Plan(d, c) for d in designs for c in (True, False)]
    for plan in plans:
        for counts in (None, fill):
            monkeypatch.setattr(hp, "probe32_plan",
                                lambda cap, aligned=True, plan=plan: plan)
            K.reset_launches()
            got = hp.hash_probe32(probe, bkeys, bvals, counts)
            torch.cuda.synchronize()
            assert K.launches["hash_probe32"] == 1
            assert torch.equal(got, want), (plan, counts is None)
    monkeypatch.undo()
    flat = torch.empty(2, buckets * cap + 1, dtype=torch.int32, device=cuda)
    flat[0, 1:], flat[1, 1:] = bkeys.flatten(), bvals.flatten()
    uk, uv = (flat[i, 1:].view(buckets, cap) for i in (0, 1))
    assert uk.data_ptr() % 16 != 0
    assert hp.probe32_plan(cap, False).design == "scalar"
    assert torch.equal(hp.hash_probe32(probe, uk, uv, fill), want)


def test_hash_join_probe_on_card(cuda):
    """The entry point on its default device: the launched kernel's rows
    equal the sorted-build oracle's once the capacity holds."""
    g = torch.Generator(device=cuda).manual_seed(1)
    m = 100_000
    build = (torch.randperm(4 * m, generator=g, device=cuda)[:m] + 1) \
        .to(torch.int32)
    rows = torch.arange(m, dtype=torch.int32, device=cuda)
    probe = torch.randint(0, 4 * m + 2, (500_000,), generator=g, device=cuda,
                          dtype=torch.int32)
    K.reset_launches()
    got, cap = hp.hash_join_probe_auto(probe, build, rows)
    assert got.device.type == "cuda" and K.launches["hash_probe32"] == 1
    assert torch.equal(got, hp_ref.hash_probe_ref(probe, build, rows))


def test_model_forward_on_card_with_and_without_kernel(cuda, monkeypatch):
    """A reduced GQA model (group 2) in float32 on the card: forward through
    the kernel (one launch per layer) equals forward through the plain
    attention and the same model on the CPU to 1e-4; prefill's last-token
    logits equal forward's; generate runs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("mistral_nemo_12b").reduced(),
                              n_kv_heads=2)
    model = Model(cfg, dtype=torch.float32)
    assert model.device.type == "cuda"
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        K.reset_launches()
        model.use_flash_kernel = True
        fast = model(tokens)
        torch.cuda.synchronize()
        assert K.launches["flash_attention"] == cfg.n_layers
        model.use_flash_kernel = False
        plain = model(tokens)
        torch.testing.assert_close(fast, plain, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(fast.cpu(), cpu(tokens), atol=1e-4,
                                   rtol=1e-4)
        last, _ = model.prefill(tokens, model.init_cache(2, 160))
        torch.testing.assert_close(last[:, 0], plain[:, -1], atol=1e-4,
                                   rtol=1e-4)
    gen = serve_lm.generate(model, tokens[:, :32], 8, 0.8,
                            torch.Generator(device=cuda).manual_seed(1))
    assert gen.tokens.shape == (2, 8) and gen.tokens.device.type == "cuda"


_MOE_CASES = [("granite_moe_3b_a800m", False), ("granite_moe_3b_a800m", True),
              ("deepseek_v2_236b", False), ("deepseek_v2_236b", True)]


@pytest.mark.parametrize("arch,full_experts", _MOE_CASES)
def test_moe_forward_on_card_equals_the_cpu(cuda, monkeypatch, arch,
                                            full_experts):
    """One MoE layer at the reduced widths in float32 (with the published
    expert count and top-k where ``full_experts``: 48 padded experts or
    160, so the rank's three-pass design): the card's slots equal
    ``counting_rank_ref``'s, its output and aux the CPU port's to 1e-4
    under the CPU's routing."""
    from repro_torch.models import moe
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    full = get_config(arch)
    cfg = full.reduced()
    if full_experts:
        cfg = dataclasses.replace(cfg, n_experts=full.n_experts,
                                  top_k=full.top_k)
    model = Model(cfg, device="cpu", dtype=torch.float32)
    p_cpu = model.layers[-1].moe
    p_card = {k: v.to(cuda) for k, v in p_cpu.items()}
    e = model.padded_experts
    x = torch.randn((4, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    t = x.shape[0] * x.shape[1]
    with torch.inference_mode():
        _, top_w, top_e = moe.route(p_cpu, cfg, x.reshape(t, -1), e)
        cap = moe.capacity(t, cfg, e, 1.25)
        want, want_slot, want_counts = moe.dispatch(
            p_cpu, cfg, x.reshape(t, -1), top_w, top_e, e, cap)
        K.reset_launches()
        got, slot, counts = moe.dispatch(
            p_card, cfg, x.reshape(t, -1).to(cuda), top_w.to(cuda),
            top_e.to(cuda), e, cap)
        torch.cuda.synchronize()
        assert K.launches["counting_rank"] == 1
        assert K.launches["counting_rank_onepass"] == int(e + 2 <= 32)
        ref_slot, ref_counts = rh_ref.counting_rank_ref(
            top_e.reshape(-1).to(cuda, torch.int32), e + 1)
        assert torch.equal(slot, ref_slot) and torch.equal(slot.cpu(),
                                                           want_slot)
        assert torch.equal(counts, ref_counts[:e])
        assert torch.equal(counts.cpu(), want_counts)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        out, aux = moe.moe_forward(p_card, cfg, x.to(cuda), e)
        want_out, want_aux = moe.moe_forward(p_cpu, cfg, x, e)
        assert torch.equal(aux["expert_load"].cpu(), want_aux["expert_load"])
        torch.testing.assert_close(out.cpu(), want_out, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "granite_moe_3b_a800m",
                                  "zamba2_1_2b", "rwkv6_3b"])
def test_model_families_on_card_equal_the_cpu(cuda, monkeypatch, arch):
    """The reduced config in float32: forward logits (through the flash
    kernel where the config has GQA attention) equal the CPU's to 1e-4,
    and prefill with three greedy decode steps give the CPU's ids."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    model = Model(cfg, dtype=torch.float32, use_flash_kernel=True)
    cpu = Model(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        torch.testing.assert_close(model(tokens).cpu(), cpu(tokens),
                                   atol=1e-4, rtol=1e-4)
        ids = []
        for m in (model, cpu):
            logits, cache = m.prefill(tokens, m.init_cache(2, 64 + 4))
            tok = logits[:, -1:].argmax(-1)
            out = [tok]
            for i in range(3):
                logits, cache = m.decode(tok, cache, 64 + i)
                tok = logits.argmax(-1)
                out.append(tok)
            ids.append(torch.cat(out, dim=1).cpu())
    assert torch.equal(ids[0], ids[1])


def test_train_step_on_card_equals_the_cpu(cuda, monkeypatch):
    """Granite-MoE-3B reduced in float32: one step of ``make_train_step``
    on the card (remat ``full``, so the counting-rank kernel runs twice a
    MoE layer) against the same step on the CPU (no remat): the metrics at
    relative 1e-5, every parameter after the step at relative L2 1e-4."""
    from repro_torch.train import optimizer, trainstep
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("granite_moe_3b_a800m").reduced()
    model = Model(cfg, dtype=torch.float32, expert_pad=1, remat="full")
    cpu = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab, (4, 64),
                           generator=torch.Generator().manual_seed(0))
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    metrics = {}
    for m in (cpu, model):
        step = trainstep.make_train_step(m, ocfg)
        state = trainstep.init_train_state(m)
        t = tokens.to(m.device)
        K.reset_launches()
        metrics[m.device.type] = {k: float(v) for k, v in
                                  step(state, {"tokens": t, "labels": t})
                                  .items()}
    assert K.launches["counting_rank"] == 2 * cfg.n_layers
    for k, want in metrics["cpu"].items():
        assert metrics["cuda"][k] == pytest.approx(want, rel=1e-5, abs=1e-7), k
    want = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach()
        rel = float(torch.linalg.norm(p.detach().cpu() - w) /
                    torch.linalg.norm(w).clamp(min=1e-30))
        assert rel <= 1e-4, (name, rel)


# ---------------------------------------------------------------------------
# serving and approximate answers on the card
# ---------------------------------------------------------------------------

def _serve_stream():
    """Every sample of all 22 templates, round-robin (29 requests)."""
    from repro_torch import serve
    per = [[(t, s) for s in t.samples]
           for _, t in sorted(serve.TEMPLATES.items())]
    out, i = [], 0
    while any(per):
        if per[i % len(per)]:
            out.append(per[i % len(per)].pop(0))
        i += 1
    return out


def _same_bytes(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert got[k].tobytes() == want[k].tobytes(), (label, k)


@pytest.fixture(scope="module")
def serve_db():
    return tpch.generate(0.05, seed=11)


def test_served_stream_equals_run_local_on_card(cuda, serve_db):
    """The prepared path on the card: one preparation per template, and
    every served result byte-identical to run_local of the bound template
    (bindings enter as 0-d device tensors there, Python numbers here)."""
    from repro_torch import serve
    reqs = _serve_stream()
    srv = serve.QueryServer(serve_db)
    assert srv.device.type == "cuda"
    for _ in range(2):
        got = srv.serve(reqs, infer=True)
    assert srv.recompiles == len(serve.TEMPLATES)
    assert srv.cache_hits == 2 * len(reqs) - len(serve.TEMPLATES)
    for (t, s), out in zip(reqs, got):
        want, _ = B.run_local(t.bind(**s).with_inference(True), serve_db)
        _same_bytes(out, want, (t.name, s))


def test_batch_equals_sequential_on_card(cuda, serve_db):
    from repro_torch import serve
    reqs = _serve_stream()
    bx = serve.BatchExecutor(serve_db)
    got = bx.run_batch(reqs, infer=True)
    assert bx.shared_hits > 0
    for (t, s), out in zip(reqs, got):
        want, _ = B.run_local(t.bind(**s).with_inference(True), serve_db)
        _same_bytes(out, want, (t.name, s))


@pytest.mark.parametrize("qid", [1, 6, 18])
def test_rung1_identity_on_card(cuda, serve_db, qid):
    from repro_torch.approx.rewrite import rewrite_for_rung
    rw = rewrite_for_rung(QUERIES[qid], serve_db, 1)
    exact, _ = B.run_local(QUERIES[qid], serve_db)
    got, _ = B.run_local(rw.query, rw.db)
    _same_bytes(got, exact, f"q{qid} rung 1")
    # the rung's device tables are the base's resident tensors plus one
    base = B.device_tables(serve_db, cuda)
    rung = B.device_tables(rw.db, cuda)
    assert all(rung[t] is base[t] for t in base)


def test_serve_tolerance_on_card(cuda, serve_db):
    from repro_torch import serve
    srv = serve.QueryServer(serve_db)
    approx = srv.submit(6, tolerance=0.0)
    _same_bytes(approx, srv.submit(6), "q6 rung 1 against exact")
    assert srv.approx_escalations == 4
    srv.submit(18, tolerance=0.5)
    assert srv.approx_refused == 1


def test_bench_run_at_smallest_sizes(cuda, tmp_path):
    """Every bench of ``repro_torch.bench.run`` on the card at its smallest
    sizes.  At these sizes a query takes a few launches' time, so the
    wall-clock gates (the ladder's walls, the recovery ratios) say nothing
    and are not asked; the gates that count hold."""
    import json
    from repro_torch.bench import run as bench
    secs = bench.run(bench.ORDER, str(cuda), bench.SMALLEST, out_dir=tmp_path)
    assert list(secs) == list(bench.ORDER)
    reports = {name: json.loads((tmp_path / f"{name}.json").read_text())
               for name in bench.GATED}
    for name in ("bench_exchange_bytes", "bench_sort_tax", "bench_serve"):
        assert reports[name]["pass"] is True, name
    for qid, checks in reports["bench_approx"]["checks"].items():
        for name in ("rung1_byte_identical", "refusal_is_total",
                     "ci_monotone_nonincreasing", "top_rung_ci_zero"):
            assert checks[name] is True, (qid, name)
    assert all(r["snapshots"] >= 1
               for r in reports["bench_recovery"]["queries"].values())


def _example(name: str):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "plan_quickstart",
                                  "sql_quickstart", "groupby_paths",
                                  "analytics_distributed"])
def test_example_on_the_card_equals_the_cpu(cuda, name):
    """Each analytics example at sf 0.005 on its default device, the card,
    against the same example on the CPU: the same rows and columns, integers
    exactly, floats within the reference's rtol 1e-7; the grouped paths'
    sorts 1 / 0 / 0 on the card too."""
    mod = _example(name)
    args = ["--sf", "0.005", "--seed", "11"]
    got, want = mod.main(args), mod.main(args + ["--device", "cpu"])

    def same(a, b, label):
        if isinstance(b, dict):
            assert sorted(a, key=str) == sorted(b, key=str), label
            for k in b:
                if k not in ("ms",):
                    same(a[k], b[k], f"{label}/{k}")
        elif isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=label)
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-7), label
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=label)
        else:
            assert a == b, label
    same(got, want, name)
    if name == "groupby_paths":
        assert got["sorts"] == {"sort": 1, "direct": 0, "hash": 0}


def test_serve_lm_example_on_the_card(cuda):
    out = _example("serve_lm").main(["--batch", "2", "--prompt-len", "8",
                                     "--tokens", "4"])
    assert out["tokens"].shape == (2, 4)
