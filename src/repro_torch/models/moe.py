"""Mixture-of-Experts with capacity-bounded counting-rank dispatch, as
``repro.models.moe``.

The dispatch is the same primitive as the SQL shuffle
(``repro_torch.core.exchange._dispatch_offsets``): tokens are ranked by
destination expert with the counting rank (``kernels/radix_hist``: the
CUDA kernel on a card, its plain version on the CPU; no sort), placed into
(E, C) capacity buckets, and dropped on overflow.  At the MoE widths (E + 2
bins above 32) the card runs the rank's three-pass design.

The reference scatters with ``.at[...].set(mode="drop")``, which silently
drops the out-of-range index ``E * C`` that marks a dropped token; torch
indexing would raise on it, so the dispatch scatters each kept pair's
index into ``E * C + 1`` slots, cuts the last one off, and gathers the
slots' tokens and weights through it.  The combine is an ``index_add`` in the
activation dtype: on the card its order of addition is not fixed, so two
runs agree to rounding, not byte for byte.  The batched expert products
stay library calls (``torch.bmm``), as the reference computes them outside
any Pallas kernel.

In a sharded model (DTensors, ``distributed/shardings.py``) the rank is
global (the destinations replicated, ``radix_hist.ops.counting_rank``) and
the experts are parallel: ``_experts`` runs through ``local_map`` on each
rank's own expert stacks (cut over the ``model`` axis by the reference's
``_RULES_3D``, gathered over the data axes) for every token, and its sum
over the experts stays pending over ``model`` until the residual's
constraint reduces it.  All indexing then happens on local tensors, whose
backward torch 2.11's DTensor could not place.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core.exchange import _dispatch_offsets
from .common import (ArchConfig, dense_init, glu_act, on_mesh, param_dict,
                     placed_as)

_I64 = torch.int64


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype,
             padded_experts: int) -> nn.ParameterDict:
    """The router (d, E) and the experts' (E, d, f) / (E, f, d) weights,
    plus the shared experts' GLU where the config has them.  ``dense_init``
    takes fan_in from the first dimension, which is E for an expert array,
    as the reference's init does."""
    d, fe, e = cfg.d_model, cfg.d_ff_expert, padded_experts
    p = {"router": dense_init(gen, (d, e), dtype, scale=0.02),
         "w_gate": dense_init(gen, (e, d, fe), dtype),
         "w_up": dense_init(gen, (e, d, fe), dtype),
         "w_down": dense_init(gen, (e, fe, d), dtype)}
    if cfg.n_shared_experts:
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        p["shared_gate"] = dense_init(gen, (d, fs), dtype)
        p["shared_up"] = dense_init(gen, (d, fs), dtype)
        p["shared_down"] = dense_init(gen, (fs, d), dtype)
    return param_dict(p)


def capacity(tokens: int, cfg: ArchConfig, padded_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: the reference's formula, a multiple of 8 and at
    least 8."""
    k, e = cfg.top_k, padded_experts
    return max(8, int(tokens * k * capacity_factor / e + 0.999) // 8 * 8 + 8)


def route(p, cfg: ArchConfig, xt: torch.Tensor, padded_experts: int):
    """xt (T, d) -> (probs (T, E) float32, top_w (T, k) renormalised,
    top_e (T, k)): the padding experts masked out, the k most probable in
    descending order (``torch.topk`` sorted, as ``jax.lax.top_k``).  The
    weights are read out of ``probs`` through a one-hot product (the same
    values exactly), so no gradient flows through ``topk``: its backward
    scatters into zeros that torch 2.11 makes as a plain tensor, which a
    DTensor model cannot mix with its own."""
    logits = (xt @ p["router"]).float()
    iota = on_mesh(torch.arange(padded_experts, device=xt.device), logits)
    if padded_experts > cfg.n_experts:
        logits = logits.masked_fill(iota >= cfg.n_experts, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.topk(probs.detach(), cfg.top_k, dim=-1, sorted=True)[1]
    top_w = (probs[:, None, :] * (top_e[..., None] == iota)).sum(-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def dispatch(p, cfg: ArchConfig, xt: torch.Tensor, top_w: torch.Tensor,
             top_e: torch.Tensor, padded_experts: int, cap: int):
    """The routed experts' output (T, d) for tokens ``xt`` (T, d) under the
    routing (top_w, top_e), each expert taking at most ``cap`` of its
    (token, expert) pairs in token order -> (out, slot (T k,) int32, counts
    (E,) int32): ``slot`` is each pair's rank among its expert's pairs (a
    pair is kept where slot < cap), ``counts`` the pairs per expert."""
    t, d = xt.shape
    e, k = padded_experts, cfg.top_k
    n = t * k
    dest = top_e.reshape(n).to(torch.int32)
    slot, counts = _dispatch_offsets(dest, e)
    keep = slot < cap
    flat = torch.where(keep, dest.to(_I64) * cap + slot.to(_I64), e * cap)
    # the pair in each (expert, capacity) slot, n where empty: one scatter
    # into E*C + 1 slots, the last (the drop slot) cut off
    pair = on_mesh(torch.full((e * cap + 1,), n, dtype=_I64,
                              device=xt.device), flat)
    pair = pair.scatter(0, flat, on_mesh(torch.arange(n, device=xt.device),
                                          flat))[:-1].reshape(e, cap)
    w = (p["w_gate"], p["w_up"], p["w_down"])
    if not isinstance(xt, DTensor):
        return _experts(*w, xt, top_w, pair, cfg.act, k), slot, counts
    # expert parallel: each rank runs its own experts (their stacks cut
    # over the mesh dims that cut w_gate's first dim) on its share of their
    # capacity slots (cut over every other mesh dim), reading every token;
    # its sum into the tokens is pending over all the mesh dims, and so is
    # its share of the stacks' gradient over the dims that do not cut them
    mesh = xt.device_mesh
    ep = [isinstance(q, Shard) and q.dim == 0 for q in w[0].placements]
    cut = [Shard(0) if x else Replicate() for x in ep]
    slots = [Shard(0) if x else Shard(1) for x in ep]
    whole = [Replicate()] * mesh.ndim
    partial = [Partial()] * mesh.ndim
    w_grad = [Shard(0) if x else Partial() for x in ep]
    out = local_map(_experts, out_placements=partial,
                    in_placements=(cut, cut, cut, whole, whole, slots, None,
                                   None),
                    in_grad_placements=(w_grad, w_grad, w_grad, partial,
                                        partial, slots, None, None),
                    device_mesh=mesh, redistribute_inputs=True)(
        *w, xt, top_w, pair, cfg.act, k)
    return out, slot, counts


def _experts(w_gate, w_up, w_down, xt, top_w, pair, act: str, k: int):
    """The routed experts' summed output (T, d): ``pair`` (E, C) holds the
    (token, expert) pair in each of the experts' slots, T k where empty;
    the weights are those experts' stacks."""
    e, cap = pair.shape
    t, d = xt.shape
    n = top_w.numel()
    pair = pair.reshape(e * cap)
    slot_used = pair < n
    pair = torch.where(slot_used, pair, 0)
    # empty slots -> token 0, weight 0, as the reference's scatters leave them
    slot_token = pair // k
    slot_w = torch.where(slot_used, top_w.reshape(n)[pair], 0.0)
    gathered = xt[slot_token].reshape(e, cap, d)
    gathered = torch.where(slot_used.reshape(e, cap, 1), gathered,
                           torch.zeros((), dtype=xt.dtype, device=xt.device))

    h = glu_act(torch.bmm(gathered, w_gate), torch.bmm(gathered, w_up), act)
    out_ec = torch.bmm(h, w_down).reshape(e * cap, d)

    # empty slots carry weight 0, so their adds to token 0 change nothing
    return torch.zeros((t, d), dtype=xt.dtype, device=xt.device).index_add(
        0, slot_token, (out_ec.float() * slot_w[:, None]).to(xt.dtype))


def moe_forward(p, cfg: ArchConfig, x: torch.Tensor, padded_experts: int,
                capacity_factor: float = 1.25):
    """x (B, S, D) -> (out (B, S, D), aux).  Top-k routing, capacity drop,
    shared experts; aux holds the load-balancing loss ``lb_loss``, the
    dropped share of (token, expert) pairs ``drop_frac`` and the pairs per
    expert ``expert_load``."""
    b, s, d = x.shape
    e, k = padded_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, top_w, top_e = route(p, cfg, xt, e)
    cap = capacity(t, cfg, e, capacity_factor)
    out, slot, counts = dispatch(p, cfg, xt, top_w, top_e, e, cap)
    if cfg.n_shared_experts:
        out = out + glu_act(xt @ p["shared_gate"], xt @ p["shared_up"],
                            cfg.act) @ p["shared_down"]

    # load-balancing aux (GShard): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = on_mesh(torch.zeros(e, dtype=torch.float32, device=x.device),
                 x).index_add(
        0, top_e.reshape(t * k), on_mesh(torch.full((t * k,), 1.0 / (t * k),
                                                    device=x.device), x))
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - (slot < cap).float().mean(),
           "expert_load": counts}
    # back to the tokens' own placement before the reshape (DTensor's view
    # of a token dim cut over two mesh dims into (B, S) is unsound)
    return placed_as(out, xt).reshape(b, s, d), aux
