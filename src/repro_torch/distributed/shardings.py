"""Sharding rules, as ``repro.distributed.shardings``: a spec for each
parameter by its name, for the batch and for the caches, and the
activation hook ``Model(constrain=...)``, placed with DTensor
(``torch.distributed.tensor``) over a named ``DeviceMesh``.

Scheme: 2-D parameter sharding: FSDP over the data (and pod) axes on one
matrix dim, tensor parallelism over ``model`` on the other; the experts
shard over ``model`` (EP); the optimizer state takes its parameter's
placements (ZeRO-3).  KV caches shard the batch over data, except at batch
1 (long-context decode), where the sequence dim shards over data.

A spec is a :class:`Spec`, one entry per tensor dim: a mesh axis name, a
tuple of names (the dim sharded over each, major to minor) or None, so it
compares with the reference's ``PartitionSpec`` entry for entry.  The
reference stacks each segment's layers on a leading axis and gives that
axis None; the port keeps one module per layer (``layers.{i}.attn.wq``),
so its spec is the reference's with the leading None dropped.
:func:`placements` turns a spec into DTensor placements on a mesh: a dim
named by mesh axes takes ``Shard(dim)`` on each of them (DTensor shards a
dim over several mesh dims in mesh order, as JAX orders the tuple), every
other mesh dim ``Replicate()``.  Where a dim does not divide, DTensor cuts
it as ``torch.chunk`` does (the first shards are the largest); XLA pads
every shard to the largest.

The tensors themselves live on :func:`compute_mesh`: the mesh itself, or
for the multi-pod mesh (pod, data, model) its 2-D view with pod and data
flattened into one dim ``pod_data``, pod major.  A dim sharded over
("pod", "data") is laid out the same on both (rank pod * D + data holds
chunk pod * D + data), but DTensor's strategy search on a 3-D mesh took
minutes for one attention einsum (torch 2.13, CPU), where GSPMD treats
the pair as one axis anyway.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.common import ArchConfig

__all__ = ["Spec", "MeshAxes", "param_specs", "batch_specs", "cache_specs",
           "make_constrain", "placements", "distribute_model",
           "distribute_tree", "shard_like", "compute_mesh"]


class Spec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


class MeshAxes:
    """fsdp = axes sharding the 'data' matrix dim; tp = tensor axis."""

    def __init__(self, fsdp: Sequence[str] = ("data",), tp: str = "model"):
        self.fsdp = tuple(fsdp)
        self.tp = tp

    def dp(self):
        return self.fsdp


# rule table: leaf name -> spec skeleton with 'F' (fsdp), 'T' (tp), None
_RULES_2D = {
    "embed": ("T", "F"), "lm_head": ("F", "T"),
    "wq": ("F", "T"), "wk": ("F", "T"), "wv": ("F", "T"), "wo": ("T", "F"),
    "wg": ("F", "T"),
    "w_gate": ("F", "T"), "w_up": ("F", "T"), "w_down": ("T", "F"),
    "shared_gate": ("F", "T"), "shared_up": ("F", "T"),
    "shared_down": ("T", "F"),
    "router": ("F", None),
    "wq_a": ("F", None), "wq_b": ("F", "T"),
    "wkv_a": ("F", None), "wkv_b": ("F", "T"),
    "w_in": ("F", "T"), "w_out": ("T", "F"),
    "conv_w": (None, "T"),
    "w_a": ("F", None), "w_b": (None, "F"),
    "fk": ("F", "T"), "fv": ("T", "F"), "fr": ("F", "T"),
    "u": (None, None),
}
_RULES_3D = {  # MoE expert stacks (E, D, F) / (E, F, D)
    "w_gate": ("T", "F", None), "w_up": ("T", "F", None),
    "w_down": ("T", None, "F"),
}
_RULES_1D = {
    "bq": ("T",), "bk": ("T",), "bv": ("T",), "conv_b": ("T",),
    "a_log": ("T",), "dt_bias": ("T",), "d_skip": ("T",),
}


def _dp(axes: MeshAxes):
    dp = axes.dp()
    return dp if len(dp) > 1 else dp[0]


def _resolve(skel, axes: MeshAxes) -> Spec:
    out = []
    for s in skel:
        if s == "F":
            if not axes.fsdp:                  # serving: TP-only params
                out.append(None)
            else:
                out.append(_dp(axes))
        elif s == "T":
            out.append(axes.tp)
        else:
            out.append(None)
    return Spec(*out)


def _leaves(params) -> Iterable[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return params.named_parameters()
    return params.items()


def param_specs(params, axes: MeshAxes) -> dict[str, Spec]:
    """{name: spec} for a model's parameters (an ``nn.Module`` or a dict of
    tensors by state-dict name; meta tensors do)."""
    out = {}
    for path, leaf in _leaves(params):
        name, nd = path.rsplit(".", 1)[-1], leaf.ndim
        rules = {3: _RULES_3D, 2: _RULES_2D, 1: _RULES_1D}.get(nd, {})
        skel = rules.get(name)
        out[path] = Spec(*([None] * nd)) if skel is None else \
            _resolve(skel, axes)                     # replicate norms etc.
    return out


def batch_specs(axes: MeshAxes, spec_like: Mapping) -> dict[str, Spec]:
    """tokens/labels (B, S) -> batch over dp; patches (B, P, D) likewise."""
    dp = _dp(axes)
    return {k: Spec(dp, *([None] * (len(v.shape) - 1)))
            for k, v in spec_like.items()}


def cache_specs(cfg: ArchConfig, cache_like, axes: MeshAxes, batch: int,
                mesh_shape: Mapping[str, int]):
    """KV-cache and state specs in the cache's own structure
    (``Model.init_cache``'s); batch-1 long decode shards the sequence
    dim."""
    dp_axes = axes.dp()
    dp = _dp(axes)
    dp_size = math.prod(mesh_shape[a] for a in dp_axes)
    tp_size = mesh_shape[axes.tp]
    batch_sharded = batch % dp_size == 0 and batch >= dp_size

    def rule(name, leaf) -> Spec:
        # KV caches: (B, S, H, hd) | MLA (B, S, r) | states (B, ...)
        nd = leaf.ndim
        spec: list = [None] * nd
        if nd >= 1:
            if batch_sharded:
                spec[0] = dp
            elif name in ("k", "v", "ckv", "krope") and nd >= 2:
                spec[1] = dp                      # seq-sharded flash-decode
        if name in ("k", "v") and nd == 4 and cfg.n_kv_heads % tp_size == 0:
            spec[2] = axes.tp
        return Spec(*spec)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, i) for i, v in enumerate(node))
        return rule(name, node)

    return walk(cache_like)


def compute_mesh(mesh):
    """The mesh the tensors live on: ``mesh``, or the multi-pod mesh's 2-D
    view (pod_data, model)."""
    names = mesh.mesh_dim_names
    if not ("pod" in names and "data" in names):
        return mesh
    view = getattr(mesh, "_repro_compute", None)
    if view is None:
        mesh["pod", "data"]._flatten("pod_data")
        view = mesh["pod_data", *[n for n in names
                                  if n not in ("pod", "data")]]
        mesh._repro_compute = view
    return view


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (its dims named); a tuple
    entry whose names are flattened into one dim (``pod_data``) shards over
    that dim."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        group = entry if isinstance(entry, tuple) else (entry,)
        if "_".join(map(str, group)) in names:
            group = ("_".join(group),)
        for axis in group:
            if axis is not None:
                out[names.index(axis)] = Shard(dim)
    return out


def shard_like(t: torch.Tensor, mesh, spec: Sequence) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor on
    :func:`compute_mesh` placed by ``spec``: each rank keeps its own shard,
    no collective."""
    mesh = compute_mesh(mesh)
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def distribute_model(model: nn.Module, mesh, axes: MeshAxes) -> nn.Module:
    """Replace every parameter of ``model`` (built the same on every rank)
    by a DTensor parameter placed by :func:`param_specs`; in place."""
    specs = param_specs(model, axes)
    for path, spec in specs.items():
        owner, _, leaf = path.rpartition(".")
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(shard_like(p.data, mesh, spec),
                                           requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, specs, mesh):
    """A tree of whole tensors and its spec tree (the same structure) ->
    the tree of DTensors."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return shard_like(tree, mesh, specs)


def make_constrain(mesh, axes: MeshAxes, seq_parallel: bool = False):
    """Activation-sharding hook for ``Model(constrain=...)``: redistributes
    a DTensor to the reference's placement for its kind (a plain tensor
    passes through).

    ``seq_parallel`` shards the residual stream's sequence dim over the tensor
    axis (Megatron-SP): the norm/elementwise chains between attention and MLP
    run on 1/TP of the tokens instead of being replicated TP times, and the
    output-projection all-reduce splits into reduce-scatter + all-gather.

    A dim that its axes do not divide (a decode step's one token, batch 1
    at long-context decode) stays whole: DTensor will not flatten an uneven
    shard into a product, where XLA pads it; nor a cut dim of one, even over
    a mesh dim of one rank."""
    dp = _dp(axes)
    mesh = compute_mesh(mesh)
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def ways(entry) -> int:
        group = entry if isinstance(entry, tuple) else (entry,)
        if "_".join(group) in size:
            return size["_".join(group)]
        return math.prod(size[a] for a in group)

    def placed(x, spec) -> tuple:
        return tuple(placements(mesh, Spec(
            *(e if e is None or x.shape[d] > 1 and x.shape[d] % ways(e) == 0
              else None for d, e in enumerate(spec)))))

    def constrain(x, kind: str):
        if x.ndim < 2 or not isinstance(x, DTensor):
            return x
        if kind == "logits":
            spec = [dp, *([None] * (x.ndim - 2)), axes.tp]
        else:
            spec = [dp, *([None] * (x.ndim - 1))]
        # the gradient is placed by ``spec``; under seq_parallel the value
        # is also cut over the sequence
        grad = placed(x, spec)
        if kind == "residual" and seq_parallel and x.ndim == 3:
            spec = [dp, axes.tp, None]
        return _Constrain.apply(x, mesh, placed(x, spec), grad)

    return constrain


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient to ``grad``,
    as JAX's sharding constraint also constrains the cotangent.  DTensor's
    own redistribution hands the gradient back as it arrives: a pending sum
    over ``model`` from the next layer's column-parallel products would
    reach the row-parallel product's backward, which would then gather its
    weight and repeat the product on every ``model`` rank, and a logits
    gradient whole over the vocabulary would make the head's weight
    gradient whole too.  Under ``seq_parallel`` the gradient's sequence is
    not cut (torch 2.11 will not flatten a sharded dim in the products'
    backward)."""

    @staticmethod
    def forward(ctx, x, mesh, pl, grad):
        ctx.grad = grad
        out = x.redistribute(mesh, pl)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.grad:
            g = g.redistribute(g.device_mesh, ctx.grad)
        return g, None, None, None
