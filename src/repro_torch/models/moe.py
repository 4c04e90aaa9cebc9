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
the experts are parallel (:func:`_dispatch_sharded`): each rank runs its own
expert stacks (cut over the ``model`` axis by the reference's
``_RULES_3D``) on its share of their capacity slots, receives only those
slots' tokens (a reduce-scatter over the data axes) and hands each slot's
output back to the rank that holds its token (an all-gather), and the sum
over the experts stays pending over ``model`` until the residual's
constraint reduces it.  All indexing happens on local tensors, whose
backward torch 2.11's DTensor could not place.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.core.exchange import _dispatch_offsets
from .common import (ArchConfig, dense_init, glu_act, on_mesh, param_dict,
                     placed_as, run_local, whole_dim)

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
        x_slots = _slot_tokens(xt, pair, k, n, 0)
        out_ec = _experts(*w, x_slots, cfg.act)
        return _combine(out_ec, pair, top_w, k, n, 0), slot, counts
    return _dispatch_sharded(w, xt, top_w, pair, cfg.act, k), slot, counts


def _dispatch_sharded(w, xt: DTensor, top_w: DTensor, pair: DTensor,
                      act: str, k: int) -> DTensor:
    """:func:`dispatch`'s three stages on a mesh.  The experts' stacks are
    cut over the mesh dims that cut ``w_gate``'s first dim (expert
    parallel), the tokens over those that cut ``xt``'s rows (the data
    dims), and each rank runs its own experts on its share of their
    capacity slots (cut over every other mesh dim):

    1. each rank fills the slots of its experts whose tokens it holds, the
       rest zero, and a reduce-scatter over the token dims hands each rank
       its own slots' tokens and no others;
    2. the experts run on those slots (:func:`_experts_on_mesh`);
    3. an all-gather over the token dims hands each rank its experts'
       slots, and each adds, weighted, those of its own tokens: the sum
       over the experts stays pending over the expert dims until the
       residual's constraint reduces it.

    Every index is read on local tensors, whose backward torch 2.11's
    DTensor could not place."""
    mesh = xt.device_mesh
    e, cap = pair.shape
    n = top_w.numel()
    ep = [isinstance(q, Shard) and q.dim == 0 for q in w[0].placements]
    tok = [not x and isinstance(q, Shard) and q.dim == 0
           for x, q in zip(ep, xt.placements)]
    rows = [Shard(0) if c else Replicate() for c in tok]
    t0 = compute_local_shape_and_global_offset(xt.shape, mesh, rows)[1][0]
    mine = [Shard(0) if x else Replicate() for x in ep]
    row_grad = [Shard(0) if c else Partial() if x else Replicate()
                for c, x in zip(tok, ep)]
    x_slots = run_local(
        lambda x, q: _slot_tokens(x, q, k, n, t0), mesh,
        [(xt, rows, row_grad), (pair, mine, None)],
        [Shard(0) if x else Partial() if c else Replicate()
         for x, c in zip(ep, tok)], (e, cap, xt.shape[1]))
    out_ec = _experts_on_mesh(w, x_slots, act, ep)
    return run_local(
        lambda o, q, tw: _combine(o, q, tw, k, n, t0), mesh,
        [(out_ec.redistribute(mesh, mine), mine,
          [Shard(0) if x else Partial() if c else Replicate()
           for x, c in zip(ep, tok)]),
         (pair, mine, None), (top_w, rows, row_grad)],
        [Shard(0) if c else Partial() if x else Replicate()
         for c, x in zip(tok, ep)], tuple(xt.shape))


def _experts_on_mesh(w, x_slots: DTensor, act: str, ep: list) -> DTensor:
    """The experts' GLU on each rank's own experts (the mesh dims ``ep``)
    and share of their slots -> (E, C, d), cut as the slots.  Where the
    stacks are also cut on the model width (FSDP over the data dims) they
    are gathered there and the slots cut on their capacity, or, where that
    moves more bytes than the slots' products (2 C f against 3 d f an
    expert: a decode step's few slots), they stay in place: the slots are
    cut on the width, the gate and up products summed over it (an
    all-reduce) and the down product cut on it, as the reference's plan
    keeps them."""
    mesh = x_slots.device_mesh
    e, cap, d = x_slots.shape
    f = w[0].shape[2]
    keep = [not x and mesh.size(i) > 1 and 2 * cap < 3 * d and
            all(isinstance(q, Shard) and q.dim == dim
                for q, dim in zip(pl, (1, 1, 2)))
            for i, (x, *pl) in enumerate(zip(ep, *(t.placements
                                                  for t in w)))]

    def placed(dim, grad=False):
        return [Shard(0) if x else Shard(dim) if s else
                Partial() if grad else Replicate() for x, s in zip(ep, keep)]

    slots = [Shard(0) if x else Shard(2) if s else Shard(1)
             for x, s in zip(ep, keep)]
    x_slots = x_slots.redistribute(mesh, slots)
    if not any(keep):
        return run_local(
            lambda *t: _experts(*t, act), mesh,
            [(t, placed(0), placed(0, True)) for t in w] +
            [(x_slots, slots, slots)], slots, (e, cap, d))
    gate_up = run_local(
        lambda g, u, x: torch.cat([torch.bmm(x, g), torch.bmm(x, u)], -1),
        mesh, [(w[0], placed(1), placed(1, True)),
               (w[1], placed(1), placed(1, True)), (x_slots, slots, slots)],
        [Shard(0) if x else Partial() if s else Shard(1)
         for x, s in zip(ep, keep)], (e, cap, 2 * f))
    summed = [Shard(0) if x else Replicate() if s else Shard(1)
              for x, s in zip(ep, keep)]
    return run_local(
        lambda dn, gu: torch.bmm(glu_act(gu[..., :f], gu[..., f:], act), dn),
        mesh, [(w[2], placed(2), placed(2, True)),
               (gate_up.redistribute(mesh, summed), summed,
                [Shard(0) if x else Partial() if s else Shard(1)
                 for x, s in zip(ep, keep)])],
        slots, (e, cap, d))


def _slot_tokens(xt, pair, k: int, n: int, t0: int) -> torch.Tensor:
    """The tokens of the experts' capacity slots (E, C, d): ``pair`` (E, C)
    holds the (token, expert) pair in each slot, ``n`` (the pairs) where
    empty; ``xt`` holds tokens t0 .. t0 + len - 1, and a slot whose token
    is not among them (or that is empty) takes zeros, as the reference's
    scatters leave an empty slot."""
    tok = pair // k
    here = (pair < n) & (tok >= t0) & (tok < t0 + xt.shape[0])
    rows = xt[torch.where(here, tok - t0, 0)]
    return torch.where(here[..., None], rows,
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _experts(w_gate, w_up, w_down, x_slots, act: str) -> torch.Tensor:
    """The experts' GLU on their slots' tokens (E, C, d) -> (E, C, d)."""
    h = glu_act(torch.bmm(x_slots, w_gate), torch.bmm(x_slots, w_up), act)
    return torch.bmm(h, w_down)


def _combine(out_ec, pair, top_w, k: int, n: int, t0: int) -> torch.Tensor:
    """The slots' outputs (E, C, d) summed into their tokens, each weighted
    by its pair's routing weight, for the tokens t0 .. t0 + len - 1 that
    ``top_w`` (len, k) holds -> (len, d) in the outputs' dtype.  An empty
    slot, or one of another rank's token, adds weight 0 to row 0."""
    d = out_ec.shape[-1]
    tok = pair // k
    here = (pair < n) & (tok >= t0) & (tok < t0 + top_w.shape[0])
    w = torch.where(here, top_w.reshape(-1)[torch.where(here, pair - t0 * k,
                                                         0)], 0.0)
    out = (out_ec.float() * w[..., None]).to(out_ec.dtype)
    return torch.zeros((top_w.shape[0], d), dtype=out_ec.dtype,
                       device=out_ec.device).index_add(
        0, torch.where(here, tok - t0, 0).reshape(-1), out.reshape(-1, d))


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
    # the destinations whole, as the counting rank takes them: torch
    # 2.11's DTensor pairs a cut index with a whole source
    ce = on_mesh(torch.zeros(e, dtype=torch.float32, device=x.device),
                 x).index_add(
        0, whole_dim(top_e.reshape(t * k), 0),
        on_mesh(torch.full((t * k,), 1.0 / (t * k), device=x.device), x))
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - (slot < cap).float().mean(),
           "expert_load": counts}
    # back to the tokens' own placement before the reshape (DTensor's view
    # of a token dim cut over two mesh dims into (B, S) is unsound)
    return placed_as(out, xt).reshape(b, s, d), aux
