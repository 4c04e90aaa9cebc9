"""Mesh construction, as ``repro.launch.mesh``, over
``torch.distributed.device_mesh.init_device_mesh``.

Defined as functions (never module-level constants), so importing this
module touches no device and no process group: the caller starts the
group first (the dry-run its fake group of 256 or 512 ranks, the trainer
the launched world) and the mesh takes that group's ranks in order.
"""
from __future__ import annotations

import math

from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_analytics_mesh", "make_local_mesh",
           "make_mesh", "world_mesh", "mesh_shape"]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default group's first prod(shape) ranks."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, tp: int = 16,
                         device_type: str = "cuda"):
    """16x16 chips per pod; 2 pods when multi_pod (512 chips).

    ``tp`` re-splits the 256-chip pod between data and model axes — serving
    prefers small TP (per-token all-reduce latency scales with TP)."""
    if 256 % tp:
        raise ValueError(f"tp {tp} does not divide a pod of 256")
    dp = 256 // tp
    shape = (2, dp, tp) if multi_pod else (dp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_analytics_mesh(*, multi_pod: bool = False,
                        device_type: str = "cuda"):
    """Analytics uses a flat exchange axis: pod x data for multi-pod."""
    shape = (2, 256) if multi_pod else (256,)
    axes = ("pod", "data") if multi_pod else ("data",)
    return make_mesh(shape, axes, device_type)


def make_local_mesh(n: int | None = None, axis: str = "data",
                    device_type: str = "cuda"):
    """One named dim over the first ``n`` ranks (all of the group's when
    None)."""
    import torch.distributed as dist
    n = n or dist.get_world_size()
    return make_mesh((n,), (axis,), device_type)


def world_mesh(world: int, tp: int, multi_pod: bool,
               device_type: str = "cuda"):
    """The trainer's mesh over a launched world of ``world`` ranks:
    (world / tp, tp) as (data, model), or (2, world / 2 tp, tp) as (pod,
    data, model) under ``multi_pod``."""
    shape = mesh_shape(world, tp, multi_pod)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_shape(world: int, tp: int, multi_pod: bool) -> tuple[int, ...]:
    """:func:`world_mesh`'s shape; raises where ``world`` does not split."""
    pods = 2 if multi_pod else 1
    if tp < 1 or world % (pods * tp):
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"{pods} pod(s) x data x model {tp}")
    dp = world // (pods * tp)
    shape = (pods, dp, tp) if multi_pod else (dp, tp)
    assert math.prod(shape) == world
    return shape
