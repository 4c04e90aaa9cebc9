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
of the DTensor it meets; :func:`split_dim`, :func:`merge_dim` and
:func:`on_shards` keep heads whole where DTensor cannot cut them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map


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
    it is.  The embedding takes the vocabulary whole (DTensor's
    masked-partial gather over a sharded vocabulary fails on torch 2.13's
    CPU backend), an SSM's time loop the time dim (one gather, not one a
    step)."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
          else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def _cuts_heads(t: torch.Tensor, n: int) -> bool:
    """Whether some mesh dim of the DTensor ``t`` has more ranks than ``n``
    heads divide (8 KV heads over a model axis of 16, 24 over 16)."""
    return isinstance(t, DTensor) and \
        any(n % t.device_mesh.size(i) for i in range(t.device_mesh.ndim))


def split_dim(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with dim ``dim`` viewed as (n, size / n), e.g. a projection's
    width as (heads, head dim).  Where a mesh dim could cut the ``n`` heads
    unevenly (:func:`_cuts_heads`) the DTensor's dim is gathered before the
    view and the heads after it (a no-op forward; in the backward the
    gradient is gathered before the view's reverse): DTensor will not view
    a shard that splits a head."""
    d = dim % t.ndim
    uneven = _cuts_heads(t, n)
    if uneven:
        t = whole_dim(t, d)
    out = t.reshape(*t.shape[:d], n, t.shape[d] // n, *t.shape[d + 1:])
    return whole_dim(out, d) if uneven else out


def merge_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dims ``dim`` and ``dim + 1`` (heads, head dim) viewed as
    one, gathered around the view as :func:`split_dim` does where the
    heads could be cut unevenly."""
    d = dim % t.ndim
    uneven = _cuts_heads(t, t.shape[d])
    if uneven:
        t = whole_dim(t, d)
    out = t.reshape(*t.shape[:d], t.shape[d] * t.shape[d + 1],
                    *t.shape[d + 2:])
    return whole_dim(out, d) if uneven else out


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


def on_shards(fn, out_dims: tuple[int, int | None], *args):
    """``fn(*tensors)`` for work that is independent per (batch, head), such
    as attention, run on each rank's local shards where the first tensor
    is a DTensor.  ``args`` are (tensor, batch dim, head dim or None); the
    mesh dims that cut the first tensor's batch cut every tensor's batch,
    those that cut its heads (dividing every tensor's heads) cut their
    heads, and every other mesh dim replicates; ``out_dims`` are the result's
    (batch dim, head dim).  A tensor without heads (a mask, a shared key)
    is whole on each head shard, so its gradient there is a pending sum.
    DTensor's own propagation of these einsums refuses to flatten a
    sharded dim in torch 2.11."""
    lead, lb, lh = args[0]
    tensors = [a[0] for a in args]
    if not isinstance(lead, DTensor):
        return fn(*tensors)
    mesh = lead.device_mesh
    plan = []
    for i, p in enumerate(lead.placements):
        if isinstance(p, Shard) and p.dim == lb:
            plan.append("batch")
        elif isinstance(p, Shard) and p.dim == lh and all(
                t.shape[h] % mesh.size(i) == 0 for t, _, h in args
                if h is not None):
            plan.append("head")
        else:
            plan.append(None)

    def pl(b, h, grad=False):
        return [Shard(b) if k == "batch" else
                Shard(h) if k == "head" and h is not None else
                Partial() if k == "head" and grad else Replicate()
                for k in plan]

    def local(*ts):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in ts)).contiguous()

    return local_map(
        local, out_placements=pl(*out_dims),
        in_placements=tuple(pl(b, h) for _, b, h in args),
        in_grad_placements=tuple(pl(b, h, True) for _, b, h in args),
        device_mesh=mesh, redistribute_inputs=True)(*tensors)


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
