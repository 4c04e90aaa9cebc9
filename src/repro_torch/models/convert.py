"""Carry the reference's weights across: a ``repro.models`` parameter tree
(as numpy arrays) -> a state dict of :class:`transformer.Model`.

The reference stacks each segment's per-layer arrays on a leading (L, ...)
axis for ``lax.scan``; the port keeps one module per layer, so each stacked
array is cut into its L layers here.  Matrices keep the reference's
(in, out) layout: the port applies every weight as ``x @ w``, as the
reference does, so nothing is transposed.  Arrays come in as float32 or
float64 numpy and go out as torch tensors of the same dtype;
``Model.load_state_dict`` casts them to the model's dtype (bf16 on the
card).
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from .common import ArchConfig
from .transformer import check_supported


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
    state dict (``layers.{i}.attn.wq`` and so on)."""
    check_supported(cfg)
    state = {"embed": _tensor(tree["embed"]),
             "final_norm": _tensor(tree["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = _tensor(tree["lm_head"])
    segments = tree["segments"]
    if len(segments) != 1:
        raise ValueError(f"a dense config has one segment, got "
                         f"{len(segments)}")
    for path, stacked in _leaves(segments[0]):
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"segment array {path} has {stacked.shape[0]} "
                             f"layers, config {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{path}"] = _tensor(stacked[i])
    return state
