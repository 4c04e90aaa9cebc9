"""Plain PyTorch version of the hash-compaction dictionary insert.

``hash_insert_ref`` is ``repro.kernels.hash_group.ref.hash_insert_ref`` in
PyTorch: lockstep write-once linear probing over all rows at once, the winner
of a contended empty slot elected by a scatter-min over row indices (min is
order-free, so the result is deterministic).  It is sort-free like the
reference.  Its slot layout differs from the CUDA kernel's (threads race
there); the contract both keep is the ascending dense ranks ``ops.dict_rank``
derives, plus ``unresolved`` iff a valid row was not placed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hash_probe.ref import bucket_of, split64


def hash_insert_ref(keys: torch.Tensor, valid: torch.Tensor, cap: int,
                    rounds: int):
    """(n,) int64 keys -> (slot int32, dict_keys (cap,) int64, occupied
    (cap,) bool, unresolved 0-d bool).  ``slot[i] = -1`` for invalid rows and
    for rows still unplaced after ``rounds`` probes."""
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int64, device=dev),
                torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    k = keys.to(torch.int64)
    lo, hi = split64(k)
    b = bucket_of(lo, hi, cap)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    table = torch.zeros(cap, dtype=torch.int64, device=dev)
    occ = torch.zeros(cap, dtype=torch.bool, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    unres = valid.to(torch.bool).clone()
    for r in range(rounds):
        s = (b + r) % cap
        hit = unres & occ[s] & (table[s] == k)
        slot = torch.where(hit, s, slot)
        unres = unres & ~hit
        att = unres & ~occ[s]
        # deterministic winner per empty slot: scatter-min of row indices
        winner = torch.full((cap + 1,), n, dtype=torch.int64, device=dev) \
            .scatter_reduce_(0, torch.where(att, s, cap), iota, "amin")[:cap]
        has = winner < n
        table = torch.where(has, k[winner.clamp(max=n - 1)], table)
        occ = occ | has
        hit2 = unres & occ[s] & (table[s] == k)
        slot = torch.where(hit2, s, slot)
        unres = unres & ~hit2
    return slot.to(torch.int32), table, occ, unres.any()
