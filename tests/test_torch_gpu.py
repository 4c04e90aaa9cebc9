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


@pytest.mark.parametrize("cap", [16, 6])
def test_hash_probe_kernel_vs_plain(cuda, cap):
    """cap 6 ends its last 4-lane group past the bucket: those lanes must
    read as empty."""
    g = torch.Generator(device=cuda).manual_seed(0)
    m = 100_000
    build = torch.randperm(m, generator=g, device=cuda) - m // 2
    rows = torch.arange(m, dtype=torch.int32, device=cuda)
    table = hp.build_bucket_table64(build, rows, hp.next_pow2(2 * m) // 4,
                                    cap=cap)
    probe = torch.randint(-m, m, (300_000,), generator=g, device=cuda)
    assert torch.equal(hp.hash_probe64(probe, *table[:3]),
                       hp_ref.hash_probe64_ref(probe, *table[:3]))


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
    local = ("segsum_sum", "segsum_minmax", "hash_insert", "hash_probe64")
    assert all(K.launches[k] > 0 for k in local), K.launches


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


@pytest.mark.parametrize("n", [1, 2047, 2048, 300_001])
@pytest.mark.parametrize("parts", [8, 129])
@pytest.mark.parametrize("hashed", [True, False])
def test_radix_hist_kernel_vs_plain(cuda, n, parts, hashed):
    g = torch.Generator(device=cuda).manual_seed(n)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    got = rh.radix_hist(keys, parts, hashed=hashed)
    want = rh.radix_hist(keys.cpu(), parts, hashed=hashed)
    assert torch.equal(got.cpu(), want)


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
    # every shuffle's dispatch ranks its rows with the kernel
    assert (K.launches["counting_rank"] > 0) == (stats.shuffles > 0)


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
    assert got.device.type == "cuda" and K.launches["hash_probe32"] >= 1
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
