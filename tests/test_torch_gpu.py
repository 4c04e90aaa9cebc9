"""The port's CUDA kernels on the card against their plain PyTorch versions.

Marked ``gpu``: on a machine without CUDA each test skips with a reason
(decided inside the fixture, never at import, so every test worker collects
the same tests).  On a machine with an H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import backend as B
from repro_torch.data import tpch
from repro_torch.kernels.hash_group import ops as hg
from repro_torch.kernels.hash_group import ref as hg_ref
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.hash_probe import ref as hp_ref
from repro_torch.kernels.segsum import ops as ss
from repro_torch.kernels.segsum import ref as ss_ref
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
    assert all(v > 0 for v in K.launches.values()), K.launches
