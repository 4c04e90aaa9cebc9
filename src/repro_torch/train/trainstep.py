"""The train step and the serving steps, as ``repro.train.trainstep``.

``make_train_step(model, ocfg, grad_compress, microbatches)`` returns
``step(state, batch) -> metrics``: the loss and its gradients
(``torch.autograd.grad``, so the gradients are the step's own and nothing
is left behind on the parameters), accumulated in float32 over
``microbatches`` slices of the batch where there are several, then the
gradient compression, then :func:`optimizer.apply_update`, which writes the
model's parameters and ``state`` in place.  The reference's step is a pure
function of (params, state, batch); here a fault before the update leaves
model and state as they were, so the step may simply be run again, while a
fault once the update has begun may leave some leaves written: it raises
:class:`UpdateFailed`, which a retry loop must not retry.

Two results of the reference depend on how it lays its parameters out:
each segment's layers stacked on a leading axis.  Its weight decay falls
on the leaves of two or more dimensions there (:func:`weight_decayed`),
and int8_ef's per-tensor scale spans one stacked leaf
(:func:`reference_leaves`); the port decays and scales the same.

Under a mesh (the parameters DTensors, ``distributed/shardings.py``) the
batch comes sharded by ``shardings.batch_specs``; each gradient is
redistributed to its parameter's placements (a pending sum becomes its
reduce-scatter or all-reduce) and the optimizer state takes the
parameters' placements, as the reference's ``s_specs`` mirror its
parameter specs.  The metrics come back as plain tensors.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.transformer import Model, segments
from . import optimizer as opt

F32 = torch.float32
GRAD_COMPRESS = ("none", "bf16", "int8_ef")


class UpdateFailed(RuntimeError):
    """The in-place update began and failed: parameters and optimizer
    state may be partly written, so the step cannot be run again."""


def reference_leaves(model: Model) -> list[list[str]]:
    """The parameters' names grouped as the reference's leaves.  The
    reference stacks each segment's layers on a leading axis, so one of its
    leaves is one path (``attn.wq``) over all layers of a segment; every
    other parameter is a leaf of its own."""
    segment_of = [i for i, (_, count) in enumerate(segments(model.cfg))
                  for _ in range(count)]
    groups: dict = {}
    for name, _ in model.named_parameters():
        key = name
        if name.startswith("layers."):
            _, layer, path = name.split(".", 2)
            key = (segment_of[int(layer)], path)
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def weight_decayed(model: Model) -> set[str]:
    """The parameters the reference decays: its leaves of two or more
    dimensions.  A layer's parameter has one dimension more there
    (:func:`reference_leaves`), so a layer's norm scales, biases and SSM
    decays are decayed, the shared block's vectors and the final norm
    not."""
    return {name for name, p in model.named_parameters()
            if p.ndim + name.startswith("layers.") >= 2}


def _extra(batch: dict, skip: tuple[str, ...]) -> dict | None:
    return {k: v for k, v in batch.items() if k not in skip} or None


def loss_and_grads(model: Model, batch: dict):
    """``model.loss`` on ``batch`` ({"tokens", "labels"} + "patches") and
    the gradient of every parameter (which must require grad) -> (loss,
    aux, gradients by parameter name), all detached."""
    total, aux = model.loss(batch["tokens"], batch["labels"],
                            extra=_extra(batch, ("tokens", "labels")))
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
    return (total.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(names, grads)))


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's whole value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model: Model, ocfg: opt.AdamWConfig,
                    grad_compress: str = "none", microbatches: int = 1):
    """Returns ``step(state, batch) -> metrics`` for ``model``, whose
    parameters it turns to require gradients.

    ``batch``: {"tokens", "labels"} (+ "patches" for the VLM), each split on
    its first axis into ``microbatches`` equal slices.  ``state`` is
    :func:`init_train_state`'s; ``grad_compress`` one of none, bf16 and
    int8_ef (which reads and replaces ``state["ef"]``; one scale a
    reference leaf).  ``metrics``:
    float32 scalar tensors ``loss``, ``ce``, ``lb_loss``, ``drop_frac``,
    ``grad_norm`` and ``lr``, as the reference's."""
    if grad_compress not in GRAD_COMPRESS:
        raise ValueError(f"grad_compress {grad_compress!r} not in "
                         f"{GRAD_COMPRESS}")
    model.requires_grad_(True)
    decay = weight_decayed(model)
    groups = reference_leaves(model)

    def step(state: dict, batch: dict) -> dict[str, torch.Tensor]:
        params = dict(model.named_parameters())
        if microbatches == 1:
            loss, aux, grads = loss_and_grads(model, batch)
        else:
            m = microbatches
            dev = model.device
            grads = {k: torch.zeros_like(p, dtype=F32)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=F32, device=dev)
            aux = {k: torch.zeros((), dtype=F32, device=dev)
                   for k in ("lb_loss", "ce", "drop_frac")}
            for i in range(m):
                micro = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                         for k, v in batch.items()}
                l, a, g = loss_and_grads(model, micro)
                for k, gk in g.items():
                    grads[k] += gk.float() / m
                del g
                loss = loss + l / m
                aux = {k: aux[k] + a[k] / m for k in aux}
        if grad_compress == "bf16":
            grads = opt.compress_bf16(grads)
        elif grad_compress == "int8_ef":
            grads, ef = opt.compress_int8_ef(grads, state["ef"], groups)
        try:
            if grad_compress == "int8_ef":
                state["ef"] = ef
            om = opt.apply_update(ocfg, params, grads, state["opt"], decay)
        except Exception as e:
            raise UpdateFailed(f"the in-place update failed: {e}") from e
        metrics = {"loss": loss.float(), **aux, **om}
        return {k: _plain(v) for k, v in metrics.items()}

    return step


def init_train_state(model: Model, grad_compress: str = "none") -> dict:
    """{"opt": AdamW state} (+ "ef", the error-feedback residual, for
    int8_ef) for the model's parameters."""
    params = dict(model.named_parameters())
    state = {"opt": opt.init_state(params)}
    if grad_compress == "int8_ef":
        state["ef"] = opt.init_error_feedback(params)
    return state


def make_prefill_step(model: Model, batch: int, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16):
    """``prefill(inputs) -> (last-token logits, cache)`` on a fresh cache of
    (batch, max_len); ``inputs`` holds "tokens" (+ "patches")."""
    @torch.inference_mode()
    def prefill(inputs: dict):
        cache = model.init_cache(batch, max_len, dtype=cache_dtype)
        return model.prefill(inputs["tokens"], cache,
                             extra=_extra(inputs, ("tokens",)))
    return prefill


def make_decode_step(model: Model):
    """``decode(token, cache, pos) -> (logits, cache)``."""
    @torch.inference_mode()
    def decode(token: torch.Tensor, cache: dict, pos: int):
        return model.decode(token, cache, pos)
    return decode
