"""The port's checkpoints (``repro_torch.distributed.checkpoint``: atomic,
CRC-checked, restored onto a named device) and the skew utilities of
``repro_torch.distributed.fault``, on the cases of the reference's
tests/test_checkpoint_fault.py and the restore_flat cases of
tests/test_chaos.py."""
import os

import numpy as np
import pytest
import torch

from repro.distributed import fault as rfault
from repro_torch.core.perfmodel import CLUSTERS
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import (choose_exchange, salt_hot_keys,
                                           skew_imbalance)


@pytest.fixture
def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": [torch.tensor([1.5, -2.0], dtype=torch.float64),
                        np.arange(3, dtype=np.int64)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert y.numpy().dtype == x.dtype
        np.testing.assert_array_equal(y.numpy(), x)


def test_save_restore_roundtrip(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 10, tree, {"note": "x"})
    assert ckpt.latest_step(d) == 10
    out, meta = ckpt.restore(d, 10, tree, device="cpu")
    assert meta == {"note": "x"}
    assert sorted(out) == ["a", "b", "step"]
    assert isinstance(out["b"]["d"], list) and len(out["b"]["d"]) == 2
    _assert_same(tree, out)


def test_paths_in_the_manifest(tmp_path, tree):
    import json
    path = ckpt.save(str(tmp_path / "ck"), 0, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["paths"] == ["/a", "/b/c", "/b/d/0", "/b/d/1", "/step"]
    with pytest.raises(ValueError, match="paths"):
        ckpt.restore(str(tmp_path / "ck"), 0, {"a": tree["a"]}, device="cpu")


@pytest.mark.parametrize("flip", [(-1, 0x7f), (-3, 0x10), (200, 0x01)])
def test_checksum_detects_corruption(tmp_path, tree, flip):
    """One flipped bit in any leaf file (a payload byte near the end, or
    one in the middle) fails the CRC check; the unchecked read loads it."""
    offset, mask = flip
    d = str(tmp_path / "ck")
    path = ckpt.save(d, 1, {"w": torch.arange(256, dtype=torch.int64)})
    victim = os.path.join(path, "000000.npy")
    with open(victim, "r+b") as f:
        f.seek(offset, 2 if offset < 0 else 0)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ mask]))
    like = {"w": torch.zeros(256, dtype=torch.int64)}
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(d, 1, like, device="cpu")
    out, _ = ckpt.restore(d, 1, like, device="cpu", strict_checksum=False)
    assert not torch.equal(out["w"], torch.arange(256))


def test_shape_mismatch_raises(tmp_path, tree):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree)
    bad = dict(tree, a=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 3, bad, device="cpu")


def test_restore_defaults_to_cuda(tmp_path, tree):
    """Like every entry point of the port, restore lands on ``cuda``
    unless the caller names another device (and raises without CUDA)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(d, 2, tree)


def test_manager_keeps_last_k(tmp_path, tree):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(os.listdir(str(tmp_path / "ck")))
    assert steps == ["step_0000000003", "step_0000000004"]
    step, out, _ = mgr.restore_latest(tree, device="cpu")
    assert step == 4
    _assert_same(tree, out)


def test_async_save(tmp_path, tree):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(5, tree)
    tree["a"].fill_(-1.0)            # the host copy was taken at save()
    mgr.wait()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 5
    out, _ = ckpt.restore(str(tmp_path / "ck"), 5, tree, device="cpu")
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4))


def test_empty_manager_restores_nothing(tmp_path, tree):
    mgr = ckpt.CheckpointManager(str(tmp_path / "none"))
    assert mgr.restore_latest(tree, device="cpu") == (None, None, None)


def test_restore_flat_roundtrip(tmp_path):
    flat = {"a": np.arange(5), "b": np.float64(2.5).reshape(()),
            "z": torch.ones((2, 3), dtype=torch.int32)}
    ckpt.save(str(tmp_path), 3, flat,
              metadata={"keys": sorted(flat), "config": {"leg": 1}})
    got, meta = ckpt.restore_flat(str(tmp_path), 3, device="cpu")
    assert meta["config"] == {"leg": 1}
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(flat[k]))


def test_leaf_files_are_what_np_save_writes(tmp_path, tree):
    """A leaf's file holds the bytes ``np.save`` writes for it, and its
    manifest CRC is theirs: the reference's layout, written in one pass."""
    import json
    import zlib
    path = ckpt.save(str(tmp_path / "ck"), 0, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for i, leaf in enumerate(_leaves(tree)):
        want = tmp_path / f"want_{i}.npy"
        np.save(want, ckpt._host(leaf))
        got = os.path.join(path, manifest["leaves"][i]["file"])
        with open(got, "rb") as f:
            data = f.read()
        assert data == want.read_bytes()
        assert manifest["leaves"][i]["crc32"] == zlib.crc32(data)


def test_restored_leaves_are_writable_and_own_their_memory(tmp_path):
    flat = {"a": np.arange(6, dtype=np.int64)}
    ckpt.save(str(tmp_path), 0, flat, metadata={"keys": ["a"]})
    got, _ = ckpt.restore_flat(str(tmp_path), 0, device="cpu")
    got["a"][0] = 41                                # no read-only buffer
    again, _ = ckpt.restore_flat(str(tmp_path), 0, device="cpu")
    assert int(got["a"][0]) == 41 and int(again["a"][0]) == 0


def test_restore_flat_rejects_non_flat(tmp_path):
    ckpt.save(str(tmp_path), 0, {"a": np.arange(3)})    # no keys metadata
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore_flat(str(tmp_path), 0, device="cpu")


def test_restore_flat_checksum(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": np.arange(64)},
              metadata={"keys": ["a"]})
    target = tmp_path / "step_0000000001" / "000000.npy"
    raw = bytearray(target.read_bytes())
    raw[-3] ^= 0x10
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore_flat(str(tmp_path), 1, device="cpu")


# ---------------------------------------------------------------------------
# skew utilities and the Eq. 3 decision (equal to the reference's)
# ---------------------------------------------------------------------------

def test_salt_hot_keys_spreads_hot_population():
    keys = np.concatenate([np.full(1000, 7, dtype=np.int64),
                           np.arange(100, dtype=np.int64) + 100])
    salted = salt_hot_keys(keys, 8)
    hot = salted[keys == 7]
    assert len(np.unique(hot % 8)) == 8
    cold = salted[keys != 7]
    np.testing.assert_array_equal(np.unique(cold), np.unique(keys[keys != 7]))
    np.testing.assert_array_equal(salted, rfault.salt_hot_keys(keys, 8))


def test_skew_imbalance_per_node():
    counts = np.array([10, 10, 10, 10, 40, 10, 10, 10])
    assert skew_imbalance(counts, k=1) == pytest.approx(40 / 13.75)
    assert skew_imbalance(counts, k=4) == pytest.approx(70 / 55)


def test_skew_imbalance_validates_and_edges():
    with pytest.raises(ValueError, match="not divisible"):
        skew_imbalance(np.arange(10), k=4)
    with pytest.raises(ValueError, match="k must be"):
        skew_imbalance(np.arange(8), k=0)
    for counts, k in ((np.array([]), 1), (np.array([37]), 1),
                      (np.array([1, 2, 3, 4]), 4), (np.zeros(8, np.int64), 1),
                      (np.array([40, 10, 10, 10, 20, 10, 10, 10]), 4)):
        assert skew_imbalance(counts, k) == rfault.skew_imbalance(counts, k)


def test_choose_exchange_uses_eq3():
    h100 = CLUSTERS["h100_ib"]
    assert choose_exchange(h100, 1, 1e9, 10e9) == "broadcast"
    assert choose_exchange(h100, 16, 1e9, 10e9) == "shuffle"


@pytest.mark.parametrize("manager", [False, True])
def test_bf16_leaves_round_trip(tmp_path, manager):
    """A bf16 tensor, which numpy cannot hold, is saved as its int16 bits
    and restored as the same bf16 tensor, by ``save`` and by the
    asynchronous manager (whose host copy keeps the dtype)."""
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    tree = {"w": w, "v": torch.ones(4), "step": torch.tensor(3,
                                                             dtype=torch.int32)}
    if manager:
        mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(7, tree)
        step, got, _ = mgr.restore_latest(tree, device="cpu")
        assert step == 7
    else:
        ckpt.save(str(tmp_path), 7, tree)
        got, _ = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    assert got["v"].dtype == torch.float32 and torch.equal(got["v"], tree["v"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
