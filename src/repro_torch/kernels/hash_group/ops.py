"""Public wrapper: dictionary sizing, insert-or-lookup, rank derivation.

Capacity discipline, as in the reference: the dictionary is sized
``next_pow2(groups_hint * capacity_factor)``, so the runner's capacity
escalation enlarges it on re-execution; probing is bounded by ``rounds``
(the whole table for tiny dictionaries, a 32-slot window otherwise), and a
row that exhausts its window stays unresolved, which the relational layer
turns into the overflow flag.

``build_group_dict`` launches ``csrc/hash_group.cu`` on a CUDA tensor and
runs the plain version (``ref.hash_insert_ref``) on a CPU tensor.
``dict_rank`` is plain PyTorch on either device, as it is plain jnp in the
reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.hash_probe.ops import next_pow2
from .ref import hash_insert_ref

__all__ = ["default_rounds", "dict_capacity", "build_group_dict", "dict_rank"]

_MAX_ROUNDS = 32
_c = ctypes.c_void_p
_SIGNATURES = {"hash_insert": [_c, _c, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, _c, _c, _c, _c]}
_OCCUPIED = 2                   # csrc/hash_group.cu slot state "holds a key"


def default_rounds(cap: int) -> int:
    return min(cap, _MAX_ROUNDS)


def dict_capacity(groups_hint: int, factor: float = 2.0) -> int:
    """Dictionary slots for a claimed group bound under ``factor`` headroom."""
    return next_pow2(max(16, int(round(groups_hint * factor))))


def build_group_dict(keys: torch.Tensor, valid: torch.Tensor, cap: int,
                     rounds: int | None = None):
    """Insert-or-lookup (n,) int64 keys into a ``cap``-slot dictionary.

    Returns ``(slot, dict_keys, occupied, unresolved)``: per-row slot (int32,
    -1 = invalid or unresolved), the (cap,) int64 dictionary keys, the (cap,)
    occupancy mask and a 0-d bool (some valid row could not be placed).  Any
    int64 key works, negatives included.
    """
    if rounds is None:
        rounds = default_rounds(cap)
    if keys.shape != valid.shape or keys.ndim != 1 or \
            keys.device != valid.device:
        raise ValueError("build_group_dict: keys and valid must be (n,) on "
                         "one device")
    if keys.device.type == "cpu":
        return hash_insert_ref(keys, valid, cap, rounds)
    if keys.device.type != "cuda":
        raise ValueError(f"build_group_dict: unsupported device {keys.device}")
    dev = keys.device
    k = keys.to(torch.int64).contiguous()
    v = valid.to(torch.uint8).contiguous()
    n = k.shape[0]
    dkeys = torch.zeros(cap, dtype=torch.int64, device=dev)
    state = torch.zeros(cap, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    lib = K.load("hash_group", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.hash_insert(K.ptr(k), K.ptr(v), n, cap, rounds, K.ptr(dkeys),
                             K.ptr(state), K.ptr(slot), K.stream_of(k))
    K.check(lib, rc, "hash_insert")
    K.count_launch("hash_insert")
    unresolved = (valid & (slot < 0)).any()
    return slot, dkeys, state == _OCCUPIED, unresolved


def dict_rank(dict_keys: torch.Tensor, occupied: torch.Tensor,
              chunk: int = 1024) -> torch.Tensor:
    """Ascending-key dense rank per occupied slot; ``cap`` for empty slots.

    Occupied slots hold distinct keys, so ``rank[s] = #{t occupied :
    key[t] < key[s]}`` is a total order — a chunked O(cap^2) compare over the
    small dictionary, never over the rows, and no sort.
    """
    cap = dict_keys.shape[0]
    parts = []
    for s0 in range(0, cap, chunk):
        ks = dict_keys[s0:s0 + chunk]
        less = (dict_keys[None, :] < ks[:, None]) & occupied[None, :]
        parts.append(less.sum(dim=1))
    rank = torch.cat(parts) if parts else \
        torch.zeros(0, dtype=torch.int64, device=dict_keys.device)
    return torch.where(occupied, rank, cap).to(torch.int32)
