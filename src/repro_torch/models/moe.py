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
slots' tokens and weights through it.  The combine is an ``index_add_`` in the
activation dtype: on the card its order of addition is not fixed, so two
runs agree to rounding, not byte for byte.  The batched expert products
stay library calls (``torch.bmm``), as the reference computes them outside
any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.exchange import _dispatch_offsets
from .common import ArchConfig, dense_init, glu_act, param_dict

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
    descending order (``torch.topk`` sorted, as ``jax.lax.top_k``)."""
    logits = (xt @ p["router"]).float()
    if padded_experts > cfg.n_experts:
        pad = torch.arange(padded_experts, device=xt.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
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
    pair = torch.full((e * cap + 1,), n, dtype=_I64, device=xt.device)
    pair = pair.scatter_(0, flat, torch.arange(n, device=xt.device))[:-1]
    slot_used = pair < n
    pair = torch.where(slot_used, pair, 0)
    # empty slots -> token 0, weight 0, as the reference's scatters leave them
    slot_token = pair // k
    slot_w = torch.where(slot_used, top_w.reshape(n)[pair], 0.0)
    gathered = xt[slot_token].reshape(e, cap, d)
    gathered = torch.where(slot_used.reshape(e, cap, 1), gathered,
                           torch.zeros((), dtype=xt.dtype, device=xt.device))

    h = glu_act(torch.bmm(gathered, p["w_gate"]),
                torch.bmm(gathered, p["w_up"]), cfg.act)
    out_ec = torch.bmm(h, p["w_down"]).reshape(e * cap, d)

    out = torch.zeros((t, d), dtype=xt.dtype, device=xt.device).index_add_(
        0, slot_token, (out_ec.float() * slot_w[:, None]).to(xt.dtype))
    # empty slots carry weight 0, so their adds to token 0 change nothing
    return out, slot, counts


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
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(t * k), torch.full((t * k,), 1.0 / (t * k),
                                            device=x.device))
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - (slot < cap).float().mean(),
           "expert_load": counts}
    return out.reshape(b, s, d), aux
