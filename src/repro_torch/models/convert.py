"""Carry the reference's weights across: a ``repro.models`` parameter tree
(as numpy arrays) -> a state dict of :class:`transformer.Model`.

The reference stacks each segment's per-layer arrays on a leading (L, ...)
axis for ``lax.scan``; the port keeps one module per layer in one list, so
each stacked array is cut into its layers here, segment after segment,
under the global layer index (``layers.{i}...``); the hybrid's unstacked
``shared`` block maps to ``shared...``.  Matrices keep the reference's
(in, out) layout: the port applies every weight as ``x @ w``, as the
reference does, so nothing is transposed.  Arrays come in as float32 or
float64 numpy and go out as torch tensors of the same dtype;
``Model.load_state_dict`` casts each to its parameter's own dtype (bf16 on
the card, float32 for the parameters the reference keeps in float32).
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from .common import ArchConfig
from .transformer import segments


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"from_jax_params takes float32/float64 arrays, got "
                        f"{a.dtype}")
    return torch.from_numpy(np.array(a, order="C"))    # a writable copy


def _leaves(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _leaves(value, path + ".")
        else:
            yield path, value


def from_jax_params(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The reference's ``Model.init`` tree, leaves as numpy -> the port's
    state dict (``layers.{i}.attn.wq``, ``shared.ln1`` and so on)."""
    state = {"embed": _tensor(tree["embed"]),
             "final_norm": _tensor(tree["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = _tensor(tree["lm_head"])
    segs = segments(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{cfg.name} has {len(segs)} segments, the tree "
                         f"{len(tree['segments'])}")
    first = 0
    for (kind, count), seg in zip(segs, tree["segments"]):
        for path, stacked in _leaves(seg):
            stacked = np.asarray(stacked)
            if stacked.shape[0] != count:
                raise ValueError(f"{kind} segment array {path} has "
                                 f"{stacked.shape[0]} layers, config {count}")
            for i in range(count):
                state[f"layers.{first + i}.{path}"] = _tensor(stacked[i])
        first += count
    if cfg.shared_attn_every:
        for path, leaf in _leaves(tree["shared"]):
            state[f"shared.{path}"] = _tensor(leaf)
    return state
