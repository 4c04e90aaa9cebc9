"""AdamW and gradient compression, as ``repro.train.optimizer``.

Plain functions on dicts of tensors keyed by the state-dict name (what
``model.named_parameters()`` yields).  ``m`` and ``v`` are float32 whatever
the parameter's dtype and ``step`` is an int32 scalar tensor, as in the
reference.  The reference is functional and returns new trees; here
:func:`apply_update` writes the parameters, ``m``, ``v`` and ``step`` in
place under ``torch.no_grad()``, one leaf at a time: a leaf's update is
computed in float32 and cast back to the parameter's dtype, so only one
leaf's float32 temporaries are alive at once (a float32 copy of a whole
gradient tree is 13.5 GB for Granite-MoE-3B's 3.4 B parameters).

This is not ``torch.optim.AdamW``, which keeps ``m`` and ``v`` in the
parameter's dtype, scales the weights before the step rather than adding
the decay to the step's direction, decays every leaf and has no global
clip: each of those gives another result.  The reference shards the state
as its parameters (ZeRO over FSDP and TP); so does the port where the
parameters are DTensors: ``m`` and ``v`` take each parameter's placements
(``zeros_like``), and the global norm sums every leaf's local squares and
reduces them over the mesh (DTensor's pending sum).

Gradient compression models what a data-parallel all-reduce would carry:
bf16, or int8 per tensor with error feedback (the residual makes it
unbiased over steps).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Collection

import torch
from torch.distributed.tensor import DTensor

F32 = torch.float32

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to a tenth of it at
    ``total_steps``; ``step`` a number or a tensor, the rate a float32
    tensor on its device."""
    step = torch.as_tensor(step, dtype=F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _zeros(params: Tree) -> Tree:
    """float32 zeros in each parameter's shape and placements."""
    return {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}


def init_state(params: Tree) -> dict:
    """{"step": 0 (int32), "m": zeros, "v": zeros}, on the parameters'
    device."""
    dev = next(iter(params.values())).device       # a DTensor's local one
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": _zeros(params), "v": _zeros(params)}


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params: Tree, grads: Tree, state: dict,
                 decay: Collection[str]) -> dict[str, torch.Tensor]:
    """One AdamW step, in place: the gradients clipped to a global norm of
    ``cfg.grad_clip`` (taken in float32 over all leaves), the bias-corrected
    moments, decoupled weight decay (added to the step's direction before
    the rate, as the reference) on the leaves named in ``decay`` (the
    reference's: its leaves of two or more dimensions).  Returns
    {"grad_norm", "lr"} (float32 scalar tensors)."""
    step = state["step"] + 1
    stepf = step.to(F32)
    lr = lr_schedule(cfg, stepf)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if name in decay:                   # decoupled weight decay
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)     # rounded to p's dtype
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32; over DTensor
    leaves a plain scalar tensor, the same on every rank."""
    total = sum(g.float().square().sum() for g in grads.values())
    if isinstance(total, DTensor):
        total = total.full_tensor()
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def compress_bf16(grads: Tree) -> Tree:
    """The all-reduce payload in bf16 (half the bytes)."""
    return {k: g.to(torch.bfloat16) for k, g in grads.items()}


def init_error_feedback(params: Tree) -> Tree:
    return _zeros(params)


def compress_int8_ef(grads: Tree, residual: Tree, groups: list[list[str]]
                     ) -> tuple[Tree, Tree]:
    """Per-tensor int8 quantization with error feedback -> (the quantized
    gradients as float32, the new residual).  The leaves of one group of
    ``groups`` share one scale, as one tensor would.  Rounds half to even
    (``torch.round``, as ``jnp.round``)."""
    deq, new_r = {}, {}
    for names in groups:
        gs = [grads[k].float() + residual[k] for k in names]
        scale = torch.clamp(torch.stack([g.abs().max() for g in gs]).max(),
                            min=1e-9) / 127.0
        for k, g in zip(names, gs):
            deq[k] = torch.clamp(torch.round(g / scale), -127, 127) * scale
            new_r[k] = g - deq[k]
    return deq, new_r
