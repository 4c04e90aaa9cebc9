"""The inputs of the port's timing tools, on the CPU.

``tools/time_hash_kernels.py`` times the group-dictionary insert at "Q13's
own keys"; its ``q13_keys`` must be the keys Q13's final group-by inserts,
and its layout floor must count what a probe of the (B, C) table reads.
"""
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core import relational as rel
from repro_torch.data import tpch
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.queries import QUERIES

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import time_hash_kernels as T  # noqa: E402


def test_q13_keys_are_the_keys_q13_inserts(monkeypatch):
    db = tpch.generate(0.005, seed=11)
    seen = []
    insert = rel._hg_ops.build_group_dict

    def spy(keys, valid, cap, rounds=None):
        seen.append((keys[valid].clone(), cap))
        return insert(keys, valid, cap, rounds)

    monkeypatch.setattr(rel._hg_ops, "build_group_dict", spy)
    B.run_local(QUERIES[13], db, device="cpu")
    (got, cap), = seen
    want = T.q13_keys(db)
    assert cap == 512 and want.shape == (750,)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(want))
    assert (want == 0).mean() > 0.3            # customers without orders


def test_layout_floor_counts_sectors_per_warp_and_bucket():
    """One warp of 32 probes of one key reads one key row and one row
    sector; 64 probes in two warps read them twice; fill counts shrink the
    key row to its filled sectors and add the count's sector."""
    build = torch.arange(1, 100, dtype=torch.int32)
    bkeys, _, fill, _ = hp._bucket_table(build, build, 128, 64)
    probe = torch.full((32,), 5, dtype=torch.int32)
    assert T.layout_floor(probe, bkeys) == (8 + 1) * 32 + 32 * 8
    assert T.layout_floor(torch.cat([probe, probe]), bkeys) == \
        2 * (8 + 1) * 32 + 64 * 8
    b = int(hp.murmur32(probe[:1]) % 128)
    sectors = (int(fill[b]) * 4 + 31) // 32
    assert T.layout_floor(probe, bkeys, fill) == \
        (sectors + 2) * 32 + 32 * 8
