"""Checkpointing: atomic save, checksummed restore, restore onto a device.

Layout:  <dir>/step_<N>/ manifest.json + <leaf-index>.npy
A tree is nested dicts and lists (or tuples) whose leaves are tensors, numpy
arrays or numbers; it flattens in a fixed order (dict keys sorted, lists in
order) and each leaf's path is recorded in the manifest.  Tensors are copied
to the host before they are written; a bf16 tensor, which numpy cannot
hold, is written as its int16 bits and its manifest entry says
``"torch_dtype": "bfloat16"``, so it is restored as bf16.  Save is atomic
(tmp dir + rename) and optionally async (background thread); ``restore``
puts every leaf on the device the caller names.  keep_last
garbage-collects old steps only after a newer step is durable — a crash
mid-save never loses the previous checkpoint.

A DTensor leaf (a sharded model's parameter or optimizer state) is saved
whole: every rank gathers it (``full_tensor``, a collective, so every rank
of the mesh calls ``save``) and rank 0 of the default group alone writes.
``restore`` onto a tree whose leaves are DTensors places each leaf as its
counterpart is placed, on that leaf's mesh, whatever mesh it was saved
from (the reference restores "with resharding"); each rank reads the files
itself, after a barrier that lets rank 0's last write land.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.table import resolve_device

__all__ = ["save", "restore", "restore_flat", "latest_step",
           "CheckpointManager"]


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in its fixed order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{path}/{i}")]
    return [(path or "/", tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _whole(leaf):
    """A DTensor leaf gathered whole (on every rank); anything else as it
    is."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _sharded(tree) -> bool:
    return any(isinstance(x, DTensor) for _, x in _flatten(tree))


def _writer() -> bool:
    """Whether this process writes a sharded tree's files: rank 0 of the
    default group (the only process where there is none)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` as a host array (a bf16 tensor's int16 bits); with ``copy``
    never one that shares memory with the caller's tensor or array (a CPU
    tensor's ``numpy()`` does)."""
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _tensor(arr: np.ndarray, meta: dict) -> torch.Tensor:
    """A restored leaf's tensor, bf16 again where it was saved from one."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if meta.get("torch_dtype") == "bfloat16" \
        else t


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _read_leaf(path: str, meta: dict, strict_checksum: bool) -> np.ndarray:
    """A leaf's array from one read of its file: the checksum covers the
    very bytes that are parsed."""
    fp = os.path.join(path, meta["file"])
    with open(fp, "rb") as f:
        data = f.read()
    if strict_checksum and zlib.crc32(data) != meta["crc32"]:
        raise IOError(f"checksum mismatch in {fp}")
    return np.load(io.BytesIO(data)).copy()     # writable, owns its memory


def save(directory: str, step: int, tree: Any, metadata: dict | None = None):
    if _sharded(tree):
        tree = _unflatten(tree, iter([_whole(x) for _, x in _flatten(tree)]))
        if not _writer():
            return _step_dir(directory, step)
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    manifest = {"step": step, "n_leaves": len(flat),
                "paths": [p for p, _ in flat], "metadata": metadata or {},
                "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr = _host(leaf)
        fn = f"{i:06d}.npy"
        buf = io.BytesIO()
        np.save(buf, arr)                  # the bytes np.save writes a file
        data = buf.getvalue()
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(data)
        meta = {"file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
                "crc32": zlib.crc32(data)}
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            meta["torch_dtype"] = "bfloat16"
        manifest["leaves"].append(meta)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, step: int, tree_like: Any,
            device: str | torch.device | None = None,
            strict_checksum: bool = True):
    """Load into the structure of ``tree_like``, every leaf a tensor on
    ``device`` (``cuda`` unless the caller names another), a DTensor placed
    as its counterpart where that is one.  The saved paths must be
    ``tree_like``'s, and each leaf's (global) shape its counterpart's."""
    dev = resolve_device(device)
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(tree_like)
    if manifest["paths"] != [p for p, _ in flat]:
        raise ValueError(f"checkpoint paths {manifest['paths']} differ from "
                         f"the target's {[p for p, _ in flat]}")
    out = []
    for (p, like), meta in zip(flat, manifest["leaves"]):
        arr = _read_leaf(path, meta, strict_checksum)
        expect = tuple(like.shape) if hasattr(like, "shape") else ()
        if tuple(arr.shape) != expect:
            raise ValueError(f"leaf {p}: shape {arr.shape} != {expect}")
        t = _tensor(arr, meta).to(dev)
        if isinstance(like, DTensor):
            t = distribute_tensor(t, like.device_mesh, like.placements,
                                  src_data_rank=None)
        out.append(t)
    return _unflatten(tree_like, iter(out)), manifest["metadata"]


def restore_flat(directory: str, step: int,
                 device: str | torch.device | None = None,
                 strict_checksum: bool = True):
    """Load a checkpoint saved from a FLAT dict of arrays with no
    ``tree_like`` template — the reader may not know the shape of what was
    saved (the lineage-recovery path: a resuming query learns a snapshot's
    columns from the snapshot itself).

    Requires the writer to have recorded the key list as
    ``metadata["keys"]`` in save order (a flat dict flattens in sorted-key
    order).  Keeps the per-leaf CRC verification of :func:`restore`; the
    tensors land on ``device`` (``cuda`` unless the caller names another).
    """
    dev = resolve_device(device)
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = manifest["metadata"].get("keys")
    if keys is None:
        raise ValueError(
            f"{path}: not a flat-dict checkpoint (no metadata['keys'])")
    if len(keys) != manifest["n_leaves"]:
        raise ValueError(f"{path}: {len(keys)} keys vs "
                         f"{manifest['n_leaves']} leaves")
    out = {key: _tensor(_read_leaf(path, meta, strict_checksum), meta)
           .to(dev) for key, meta in zip(keys, manifest["leaves"])}
    return out, manifest["metadata"]


class CheckpointManager:
    """keep-last-k + async save."""

    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, metadata: dict | None = None):
        # copy to the host synchronously (the caller may then reuse its
        # tensors, and an in-place optimizer does), write in the background;
        # tensors stay tensors, so a bf16 leaf keeps its dtype
        # a sharded tree: every rank gathers, rank 0 alone writes
        sharded = _sharded(tree)
        host_tree = _unflatten(tree, iter([
            _whole(x).detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else _host(x, copy=True)
            for _, x in _flatten(tree)]))
        if sharded and not _writer():
            return

        def work():
            save(self.dir, step, host_tree, metadata)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    def restore_latest(self, tree_like, device=None):
        self.wait()
        if _sharded(tree_like) and dist.is_initialized():
            dist.barrier()                 # rank 0's last write has landed
        step = latest_step(self.dir)
        if step is None:
            return None, None, None
        tree, meta = restore(self.dir, step, tree_like, device)
        return step, tree, meta
