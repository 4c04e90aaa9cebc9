"""Shared model substrate: the architecture config, norms, RoPE, activations
and weight init, as in ``repro.models.common``.

Every function takes and returns tensors on the caller's device and keeps the
reference's numerics: RMS norm and RoPE run in float32 and cast back to the
input's dtype.  Weights are drawn from an explicit ``torch.Generator``; the
reference draws from ``jax.random`` keys, so the two give different numbers
from one seed (the tests carry the reference's weights across instead, with
``models/convert.py``).  On the ``meta`` device a model is built from
:class:`MetaGenerator`, which draws nothing: shapes only.

A model whose parameters are DTensors (sharded over a mesh,
``distributed/shardings.py``) computes on DTensors throughout: a tensor
the model makes itself (positions, RoPE tables, masks, zeros) is made
whole and passed through :func:`on_mesh`, which replicates it on the mesh
of the DTensor it meets.  :func:`split_dim`, :func:`merge_dim` and
:func:`on_shards` cut heads where DTensor will not (a count that the mesh
does not divide) and run per-(batch, head) work on each rank's own shards,
planned from every tensor, so that each device does the reference's share
of the work; :func:`embed_lookup` looks rows up in a table cut over its
vocabulary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact public config; see repro_torch.configs)."""
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    act: str = "swiglu"           # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma-style sqrt(d) embedding multiplier
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0   # deepseek: first layer is dense
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0    # zamba2: shared attn block cadence
    # modality frontend stubs
    frontend: str | None = None   # None | "vision_patches" | "audio_frames"
    n_prefix: int = 0             # vision: number of patch embeddings
    # attention variant
    prefix_lm: bool = False       # paligemma: bidirectional prefix
    sub_quadratic: bool = False   # eligible for long_500k
    param_count: float = 0.0      # nominal N for MODEL_FLOPS (6ND)
    active_param_count: float = 0.0  # MoE: active params per token
    # numerics: float32 norm chains are the baseline
    norms_f32: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 + (2 if self.shared_attn_every else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            d_ff_expert=min(self.d_ff_expert, 64) if self.d_ff_expert else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
            n_prefix=min(self.n_prefix, 8) if self.n_prefix else 0,
        )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             in_f32: bool = True) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)``, in float32 unless ``in_f32`` is False."""
    dt = x.dtype
    if in_f32:
        x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = (x * torch.rsqrt(var + eps)) * (1.0 + scale.to(x.dtype))
    return out.to(dt)


def on_mesh(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, made whole on every rank, as a replicated DTensor on the mesh
    of ``like`` where ``like`` is a DTensor and ``t`` is not; else ``t``."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with dim ``dim`` gathered on every rank; a plain tensor as
    it is.  An SSM's time loop takes the time dim whole (one gather, not one
    a step)."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
          else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def cut_dims(t: torch.Tensor, dim: int) -> list[int]:
    """The mesh dims that cut dim ``dim`` of the DTensor ``t`` ([] for a
    plain tensor)."""
    if not isinstance(t, DTensor):
        return []
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim % t.ndim == dim % t.ndim]


def _uneven_cut(t: torch.Tensor, dim: int, n: int) -> list[int]:
    """The mesh dims that cut dim ``dim`` of the DTensor ``t`` where
    together they do not divide its ``n`` heads (24 heads over a model axis
    of 16), else [].  A mesh dim that cuts another dim never matters."""
    cuts = cut_dims(t, dim)
    return cuts if n % math.prod(t.device_mesh.size(i) for i in cuts) else []


def _cut_dim(t: torch.Tensor, dim: int, mesh_dims: list[int]) -> torch.Tensor:
    """The DTensor ``t``, whole on ``mesh_dims``, cut there on dim ``dim``
    (a local slice; uneven where they do not divide it, the first shards
    the largest, as ``torch.chunk`` cuts)."""
    pl = list(t.placements)
    for i in mesh_dims:
        pl[i] = Shard(dim)
    return t.redistribute(t.device_mesh, pl)


def cut_over(t: torch.Tensor, dim: int, mesh_dims: list[int]
             ) -> torch.Tensor:
    """The DTensor ``t`` cut on dim ``dim`` over ``mesh_dims``, where it is
    whole (a local slice); a plain tensor, or no mesh dims, as it is."""
    return _cut_dim(t, dim % t.ndim, mesh_dims) \
        if isinstance(t, DTensor) and mesh_dims else t


def _any_uneven(t: torch.Tensor, n: int) -> bool:
    """Whether some mesh dim of the DTensor ``t`` has more ranks than ``n``
    heads divide, so that a cut there could split a head."""
    return isinstance(t, DTensor) and \
        any(n % t.device_mesh.size(i) for i in range(t.device_mesh.ndim))


def split_dim(t: torch.Tensor, dim: int, n: int,
              recut: bool = True) -> torch.Tensor:
    """``t`` with dim ``dim`` viewed as (n, size / n), e.g. a projection's
    width as (heads, head dim).  Where the mesh dims that cut the width cut
    the ``n`` heads unevenly (:func:`_uneven_cut`) the width is gathered
    before the view (DTensor will not view a shard that splits a head) and,
    with ``recut``, the heads are cut again over the same mesh dims after
    it, by a local slice: rank 0 holds ceil(n / ranks) heads, as XLA pads
    them.  Without ``recut`` they stay whole there, as the reference's
    ``cache_specs`` keeps KV heads that the model axis does not divide.
    Where some mesh dim does not divide the heads the view is followed by
    a redistribution even where nothing moves: in the backward it gathers
    a gradient cut there before the view's reverse."""
    d = dim % t.ndim
    uneven = _uneven_cut(t, d, n)
    if uneven:
        t = whole_dim(t, d)
    out = t.reshape(*t.shape[:d], n, t.shape[d] // n, *t.shape[d + 1:])
    if _any_uneven(out, n):
        out = _cut_dim(out, d, uneven if recut else [])
    return out


def merge_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dims ``dim`` and ``dim + 1`` (heads, head dim) viewed as
    one.  Heads cut unevenly are gathered before the view and the width is
    cut again over the same mesh dims after it (a local slice), as a
    row-parallel product takes it; a pending sum (:func:`on_shards`'
    balanced blocks) is reduced onto the width so cut (a reduce-scatter:
    DTensor would rather gather the product's weight and repeat the product
    on every rank).  The backward is guarded as :func:`split_dim`'s."""
    d = dim % t.ndim
    n = t.shape[d]
    uneven = _uneven_cut(t, d, n)
    if uneven:
        t = whole_dim(t, d)
    if cut_dims(t, d + 1):          # a head dim cut (a one-token state read)
        t = whole_dim(t, d + 1)
    out = t.reshape(*t.shape[:d], n * t.shape[d + 1], *t.shape[d + 2:])
    pending = [i for i, p in enumerate(out.placements) if p.is_partial()] \
        if isinstance(out, DTensor) else []
    if _any_uneven(out, n) or pending:
        out = _cut_dim(out, d, uneven + pending)
    return out


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: the einsums'
    gradients come back permuted, and DTensor views a shard's gradient as
    if it were laid out as the whole."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _plan(args) -> list[str | None]:
    """Per mesh dim of :func:`on_shards`' tensors: ``"batch"`` where some
    tensor is cut there on its batch (a KV cache), else ``"keys"`` where
    some tensor is cut there on its keys (a sequence-cut decode cache) and
    no gradient is taken (the softmax's statistics are reduced by
    collectives without a backward), else ``"head"`` where some tensor is
    cut there on its heads or holds a pending sum with heads (which then
    goes onto them), else ``"rows"`` where some tensor is cut there on its
    rows, else None (replicated): keys cut under a gradient are gathered."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t, *_ in args)
    plan = []
    for i in range(args[0][0].device_mesh.ndim):
        held = [(t.placements[i], dims) for t, *dims in args
                if isinstance(t, DTensor)]

        def cut(pick):
            return any(isinstance(p, Shard) and dims[pick] == p.dim
                       for p, dims in held)
        if cut(0):
            plan.append("batch")
        elif cut(3) and not grad:
            plan.append("keys")
        elif cut(1) or any(dims[1] is not None and p.is_partial()
                           for p, dims in held):
            plan.append("head")
        elif cut(2):
            plan.append("rows")
        else:
            plan.append(None)
    return plan


def _kv_heads(lo: int, n: int, group: int):
    """The KV heads that query heads lo .. lo + n - 1 read, ``group`` query
    heads a KV head -> (first, count, index): the local query heads read the
    KV slice (first, count) in groups of n / count, or, where a group
    straddles the shard's edge unevenly, through ``index`` (one KV head a
    query head)."""
    if n == 0:
        return 0, 0, None
    first = lo // group
    kv = [(lo + j) // group - first for j in range(n)]
    count = kv[-1] + 1
    if n % count == 0 and kv == [j // (n // count) for j in range(n)]:
        return first, count, None
    return first, count, kv


def on_shards(fn, out_dims: tuple, *args, balance: bool = False):
    """``fn(*tensors)`` for work that is independent per (batch, head), such
    as attention, run on each rank's local shards where the first tensor
    is a DTensor.  ``args`` are (tensor, batch dim, head dim or None[, row
    dim or None[, key dim or None]]); ``out_dims`` are the result's (batch
    dim, head dim[, row dim]), whose heads are the first tensor's.  Rows
    are independent positions of the first tensor (attention's queries),
    keys those that ``fn`` reduces over (its keys).

    Each mesh dim is planned from every tensor (:func:`_plan`): it cuts
    every tensor's batch, or the keys, or the heads, or nothing.  So a
    pending sum on the first tensor is reduced onto the shards that the
    others hold (a reduce-scatter of the small query), and a large tensor
    (a KV cache cut on its batch or its sequence) is never gathered to suit
    it.  Where the keys are cut (a sequence-cut decode cache), ``fn`` is
    called with ``key_groups``, the (mesh, dim) groups over which it must
    reduce its softmax's statistics, and its result is a pending sum
    there.  Heads that a mesh dim does not divide are cut as DTensor cuts
    such a dim (rank 0 the largest shard, as XLA pads them) or, with
    ``balance``, in ``gcd(heads, ranks)`` groups, each group's ranks taking
    equal parts of the local batch or of the rows (:func:`_balanced`): the
    same work on every rank, as XLA spreads it, and the result a pending
    sum there of each rank's block, zero-padded to the local shard.  The
    caller chooses: attention, whose result goes straight to
    :func:`merge_dim` (one reduce-scatter onto the width), balances; the
    SSMs' reads of their state do not: balanced, RWKV6's read (each step's
    result then meets a per-head norm, which all-reduces the padded block)
    took its prefill_32k cell on 16 x 16 to 10x the reference's collective
    bytes.  A tensor with fewer heads than the
    first (GQA's keys and values) is cut with it where both divide the
    mesh dims evenly; else it stays whole there and each rank slices,
    locally, the KV heads of its own query heads (:func:`_kv_heads`), so
    its gradient there is a pending sum.  A tensor without heads (a mask,
    a shared key) is whole on each head shard, so its gradient there is a
    pending sum too.  DTensor's own propagation of these einsums refuses
    to flatten a sharded dim in torch 2.11."""
    args = [tuple(a) + (None,) * (5 - len(a)) for a in args]
    lead, lb, lh, lr, _ = args[0]
    tensors = [a[0] for a in args]
    if not isinstance(lead, DTensor):
        return fn(*tensors)
    mesh = lead.device_mesh
    plan = _plan(args)
    heads = lead.shape[lh]

    def pl(b, h, r=None, k=None, grad=False, cut_heads=True):
        return [Shard(b) if c == "batch" else
                Shard(k) if c == "keys" and k is not None else
                Shard(h) if c == "head" and h is not None and cut_heads else
                Shard(r) if c == "rows" and r is not None else
                Partial() if c in ("head", "parts", "keys", "rows") and grad
                else Replicate() for c in plan]

    head_dims = [i for i, c in enumerate(plan) if c == "head"]
    parts = _balanced(args[0], heads, mesh, pl, plan) if balance else None
    if parts is not None:
        plan[head_dims[0]] = "parts"
        head_dims = []
    ways = 1
    for i in head_dims:
        ways *= mesh.size(i)
    local_shape, offset = compute_local_shape_and_global_offset(
        lead.shape, mesh, pl(lb, lh, lr))
    # the query heads this rank computes and, balanced, its part of the
    # local batch or of the rows
    lo, n = (offset[lh], local_shape[lh]) if parts is None else parts[0]
    slices, locals_ = [], []
    for t, b, h, r, k in args:
        cut = parts is None and (h is None or t.shape[h] == heads or (
            heads % ways == 0 and t.shape[h] % ways == 0))
        take = []
        if parts is not None:
            by_batch, first, count = parts[1]
            if by_batch or r is not None:
                take.append((b if by_batch else r, first, count, None))
        if h is not None and not cut:
            first, count, index = (lo, n, None) if t.shape[h] == heads \
                else _kv_heads(lo, n, heads // t.shape[h])
            take.append((h, first, count, index))
        slices.append(take)
        if isinstance(t, DTensor):
            t = t.redistribute(mesh, pl(b, h, r, k, cut_heads=cut)).to_local(
                grad_placements=pl(b, h, r, k, True, cut))
        locals_.append(t)

    def local(t, take):
        if t.requires_grad:
            t = _ContiguousGrad.apply(t)
        for d, first, count, index in take:
            t = t.narrow(d, first, count)
            if index is not None:
                t = t.index_select(d, torch.tensor(index, device=t.device))
        return t

    kw = {"key_groups": [(mesh, i) for i, c in enumerate(plan)
                         if c == "keys"]} if "keys" in plan else {}
    out = fn(*map(local, locals_, slices), **kw).contiguous()
    ob, oh, *orow = out_dims
    out_pl = [Partial() if c == "keys" else p
              for c, p in zip(plan, pl(ob, oh, *orow))]
    if parts is not None:           # this rank's block of the local result
        by_batch, first, count = parts[1]
        d, size = (ob, local_shape[lb]) if by_batch else \
            (orow[0], local_shape[lr])
        out = _pad_to(out, {d: (first, size - first - count),
                            oh: (lo, heads - lo - n)})
        out_pl = [Partial() if c == "parts" else p
                  for c, p in zip(plan, out_pl)]
    shape = list(out.shape)
    if "batch" in plan:
        shape[ob] = lead.shape[lb]
    if "rows" in plan:
        shape[orow[0]] = lead.shape[lr]
    shape[oh] = heads
    return _global(out, mesh, out_pl, shape)


def _global(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local`` as this rank's shard of a DTensor of global ``shape``:
    DTensor's ``from_local`` (and ``local_map``) would infer the shape as
    if every shard were as large as this one."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def _balanced(lead_arg, heads: int, mesh, pl, plan: list):
    """For :func:`on_shards` with ``balance``: where one mesh dim of m
    ranks cuts the heads and does not divide them, rank c of it computes
    head group c // p of g = gcd(heads, m) groups on part c % p of p = m / g
    equal parts of the local batch, or where those do not divide it, of
    the first tensor's rows (its queries) -> ((first head, heads), (by
    batch, first, count)); None where neither divides."""
    lead, lb, _, lr, _ = lead_arg
    head_dims = [i for i, c in enumerate(plan) if c == "head"]
    if len(head_dims) != 1 or heads % mesh.size(head_dims[0]) == 0:
        return None
    i = head_dims[0]
    m = mesh.size(i)
    groups = math.gcd(heads, m)
    p = m // groups
    whole = [Replicate() if j == i else q
             for j, q in enumerate(pl(lb, None))]
    local = compute_local_shape_and_global_offset(lead.shape, mesh, whole)[0]
    c = mesh.get_local_rank(i)
    n = heads // groups
    rows = None if lr is None or "rows" in plan else local[lr]
    for by_batch, size in ((True, local[lb]), (False, rows)):
        if size and size % p == 0:
            return (c // p * n, n), (by_batch, c % p * size // p, size // p)
    return None


def _pad_to(t: torch.Tensor, pads: dict[int, tuple[int, int]]
            ) -> torch.Tensor:
    """``t`` padded with zeros on each dim of ``pads``, (before, after)."""
    flat = []
    for d in range(t.ndim - 1, min(pads) - 1, -1):
        flat += list(pads.get(d, (0, 0)))
    return F.pad(t, flat)


def run_local(fn, mesh, ins, out_placements, shape) -> DTensor:
    """``fn`` on each rank's local tensors -> a DTensor of global ``shape``
    placed by ``out_placements``: ``ins`` are (DTensor, its placements for
    ``fn``, its gradient's placements or None)."""
    local = [t.redistribute(mesh, pl).to_local(grad_placements=g)
             for t, pl, g in ins]
    return _global(fn(*local), mesh, out_placements, shape)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a mesh where the rows looked up on a rank
    move fewer bytes than the vocabulary would (a decode step's few
    tokens), each rank looks up, locally, the rows of its own share of the
    vocabulary, zeros for the tokens outside it, and the rows are summed
    over the mesh dims that cut the vocabulary (one term not zero); the
    table's width is gathered over the mesh dims that cut the tokens' batch
    (as a product's FSDP weight is) and stays cut over the others, the
    rows then cut alike.  Else the vocabulary is gathered and each rank
    looks up its tokens whole."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    tokens = on_mesh(tokens, table)
    tok_pl, w_pl, w_grad, out_pl = [], [], [], []
    for tp, wp in zip(tokens.placements, table.placements):
        batch = isinstance(tp, Shard) and tp.dim == 0
        if isinstance(wp, Shard) and wp.dim == 0:            # the vocabulary
            plan = (Replicate(), Shard(0), Shard(0), Partial())
        elif isinstance(wp, Shard) and wp.dim == 1 and not batch:
            plan = (Replicate(), Shard(1), Shard(1), Shard(tokens.ndim))
        else:
            plan = (Shard(0), Replicate(), Partial(), Shard(0)) if batch \
                else (Replicate(),) * 4
        for out, p in zip((tok_pl, w_pl, w_grad, out_pl), plan):
            out.append(p)
    (rows, width), (first, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, w_pl)
    n_tok = math.prod(compute_local_shape_and_global_offset(
        tokens.shape, mesh, tok_pl)[0])
    vocab = math.prod(compute_local_shape_and_global_offset(
        table.shape, mesh, [Replicate() if p == Shard(0) else p
                            for p in table.placements])[0])
    if n_tok * width >= vocab:
        return F.embedding(tokens, whole_dim(table, 0))

    def lookup(tok, w):
        here = (tok >= first) & (tok < first + rows)
        out = F.embedding(torch.where(here, tok - first, 0), w)
        return torch.where(here[..., None], out,
                           torch.zeros((), dtype=w.dtype, device=w.device))

    out = run_local(lookup, mesh, [(tokens, tok_pl, None),
                                   (table, w_pl, w_grad)], out_pl,
                    (*tokens.shape, table.shape[1]))
    return placed_as(out, out)


def placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` redistributed to ``like``'s shards (replicated where
    ``like`` holds a pending sum); else ``t``."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    pl = tuple(p if isinstance(p, (Shard, Replicate)) else Replicate()
               for p in like.placements)
    return t if tuple(t.placements) == pl else \
        t.redistribute(like.device_mesh, pl)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device: weights
    made from it have shapes and dtypes and no values (the counterpart of
    ``jax.eval_shape(model.init)``)."""
    device = torch.device("meta")


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


_cpu_math_warm = False


def warm_cpu_math() -> None:
    """Run torch's CPU ``cos`` and ``sin`` once, in float32, on enough
    elements that every thread takes a part (ROADMAP C4).  Those two go
    through MKL's vector math library in 2048-element parts across threads,
    and on the H100 machine's host (torch 2.11.0+cu128, MKL 2024.2) the
    first such call of a process returned one part at about 11-bit accuracy
    in 2 of 60 fresh processes (RoPE's rotated queries off by up to 5.7e-4;
    ``tools/cpu_first_forward.py``); every later call was exact.  RoPE is
    the model's only such call, so :func:`apply_rope` runs this once per
    process before its first CPU call."""
    global _cpu_math_warm
    if not _cpu_math_warm:
        x = torch.linspace(0.0, 4096.0, 4096 * max(1, torch.get_num_threads()))
        torch.cos(x)
        torch.sin(x)
        _cpu_math_warm = True


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) integer.  Rotates the two halves
    of each head in float32 and casts back to x's dtype."""
    if x.device.type == "cpu":
        warm_cpu_math()
    d = x.shape[-1]
    freqs = on_mesh(rope_freqs(d, theta, x.device), positions)   # (D/2,)
    ang = positions.float()[..., None] * freqs             # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def glu_act(x_gate: torch.Tensor, x_up: torch.Tensor, kind: str
            ) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x_gate) * x_up
    if kind == "geglu":
        return F.gelu(x_gate, approximate="tanh") * x_up
    raise ValueError(kind)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal weights of std ``scale`` (default fan_in^-1/2, fan_in the
    first dimension), drawn in float32 on the generator's device (empty
    from a :class:`MetaGenerator`)."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(dtype)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) any float dtype; labels (B, S) integer -> the mean
    nats over (B, S), in float32.  The max is taken out of the gradient, as
    the reference's ``stop_gradient``.

    On a DTensor the gold logit is read without a gather: the labels are
    compared with a vocabulary index placed as the logits' vocabulary dim,
    and the masked sum over a vocabulary cut over ``model`` stays pending
    there, so no rank holds the whole vocabulary's logits or their
    gradient."""
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    if isinstance(shifted, DTensor):
        gold = (shifted * (labels[..., None] == _index_like(shifted, -1))
                ).sum(-1)
    else:
        gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def _index_like(t: DTensor, dim: int) -> DTensor:
    """``arange(t.shape[dim])`` as a DTensor cut as ``t``'s dim ``dim``
    (each rank makes its own shard; no collective)."""
    dim %= t.ndim
    pl = [Shard(0) if isinstance(p, Shard) and p.dim % t.ndim == dim
          else Replicate() for p in t.placements]
    return distribute_tensor(torch.arange(t.shape[dim], device=t.device),
                             t.device_mesh, pl, src_data_rank=None)


def param_dict(p: dict[str, torch.Tensor]) -> nn.ParameterDict:
    """Weights as parameters under the reference's leaf names, without
    gradients until a trainer turns them on (``requires_grad_``)."""
    return nn.ParameterDict({k: nn.Parameter(w, requires_grad=False)
                             for k, w in p.items()})
