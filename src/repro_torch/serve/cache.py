"""Compiled-plan cache: content-signature keys, FIFO bound, stats-coupled.

A :class:`PlanCache` maps ``(database, key)`` to any compiled artifact —
the serving layer stores prepared templates keyed by (plan content
signature, configuration).  Three disciplines, all inherited from the
planner's ``_planinfo_cache``:

  * **Content keys.**  The caller keys on ``plan_signature`` — same logical
    program, same entry; any structural difference (columns, literals,
    parameter specs, DAG wiring) splits.  Bindings are NOT part of the key:
    one entry serves every binding of a template.
  * **FIFO bound.**  At most ``max_entries`` live entries; a process
    compiling throwaway templates against one long-lived database cannot
    grow without bound.
  * **Stats-coupled invalidation.**  Every cache registers with the
    planner's invalidation registry at import: ``invalidate_stats(db)`` —
    called on table mutation, and by ``stats_override`` on BOTH entry and
    exit — evicts every entry compiled against ``db``.  A compiled template
    embeds statistics-derived claims (key_bits, wire bounds); serving it
    after the statistics changed would at best overflow-and-retry on every
    request, at worst (a widened domain) return a wrong answer — eviction at
    the one doorway closes that gap for every cache at once.

Entries hold a weakref to their database: a dead database's entries are
unreachable garbage and are dropped on sight, and an ``id()`` reused by a
new database can never hit an old entry.
"""
from __future__ import annotations

import weakref
from typing import Any

from repro_torch.core import planner

__all__ = ["PlanCache"]


class PlanCache:
    """FIFO-bounded ``(database, key) -> artifact`` cache (see module doc)."""

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        # (id(db), key) -> (weakref(db), artifact); dict order = FIFO
        self._entries: dict[tuple, tuple] = {}
        self.evictions = 0
        _REGISTRY.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, db, key) -> Any | None:
        entry = self._entries.get((id(db), key))
        if entry is None:
            return None
        ref, artifact = entry
        if ref() is not db:          # id() reused after gc: not our entry
            del self._entries[(id(db), key)]
            return None
        return artifact

    def put(self, db, key, artifact) -> None:
        k = (id(db), key)
        self._entries.pop(k, None)   # re-put moves to the back of the FIFO
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
        self._entries[k] = (weakref.ref(db), artifact)

    def evict_db(self, db) -> int:
        """Drop every entry compiled against ``db`` (and any dead entries);
        returns the count.  Fired through the planner invalidation registry."""
        dead = [k for k, (ref, _) in self._entries.items()
                if ref() is db or ref() is None]
        for k in dead:
            del self._entries[k]
        self.evictions += len(dead)
        return len(dead)

    def clear(self) -> None:
        self.evictions += len(self._entries)
        self._entries.clear()


# every live PlanCache, weakly — one registered dispatcher serves them all,
# and a collected cache needs no unregistration
_REGISTRY: "weakref.WeakSet[PlanCache]" = weakref.WeakSet()


def _invalidation_hook(db) -> None:
    for cache in list(_REGISTRY):
        cache.evict_db(db)


planner.register_invalidation(_invalidation_hook)
