"""Exchange-boundary lineage snapshots — resume instead of re-execute.

The paper's recovery story is whole-query re-execution (§2.4).  The exchange
cut points are exactly the replicated / reshuffled states of a plan — the
same observation "Rethinking Analytical Processing in the GPU Era" uses for
out-of-core restartability — so a runner that persists each post-exchange
table can resume a failed query from the last durable exchange, re-executing
only the plan suffix.

Mechanics: the planner executor
(:class:`repro_torch.core.planner._Executor`)
consults an attached :class:`LineageStore` at every exchange-type node
(Shuffle, Broadcast, GroupBy with a non-local exchange) BEFORE recursing
into its children.  A hit returns the snapshot and skips the whole subtree
— the executor walks root-ward, so the topmost durable exchange wins.  A
miss executes the node and persists its output through
:mod:`repro_torch.distributed.checkpoint`'s atomic, CRC-checksummed save
(the tables are copied to the host; a resume loads them back onto the
context's device).

Snapshots are written by single-device execution (:func:`run_resumable`);
the distributed engine keeps the paper's whole-query re-execution.
Snapshot tags are the node's ordinal in the deterministic ``walk()``
order; every snapshot records the (plan
fingerprint, inference leg, wire format) configuration and is ignored when
the resuming run's configuration differs — a hint-dropped or wide-format
re-run never resumes from a narrow-format snapshot.  Snapshots are never
written while ``ctx.overflow`` is set: an overflowed buffer is not durable
state.

Topology elasticity: every snapshot's pinned config carries the logical
device width (``n_devices``) the run was targeting, and snapshots are
stored in GLOBAL row order — width-independent by construction.  A resume
whose config differs ONLY in ``n_devices`` (the device-loss rung shrank the
group N -> N') therefore adopts the snapshot instead of discarding it; the
next exchange recomputes the partition assignment at N'.  Such adoptions are
counted in ``LineageStore.resharded``.  For the stacked
``partition_database`` layout (columns ``(n*cap,)``, counts ``(n,)``) the
module-level :func:`reshard` / :func:`unshard` pair re-partitions explicitly
and round-trips byte-identically via a carried ``__rowid`` anchor.
"""
from __future__ import annotations

import hashlib
import os
import shutil

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core import plan as qp
from repro_torch.core.planner import _walk_signature
from repro_torch.core.table import Table, resolve_device, to_numpy
from repro_torch.core.wire import CorruptPayload
from . import checkpoint as ckpt

__all__ = ["LineageStore", "run_resumable", "plan_fingerprint",
           "reshard", "unshard"]


def _canon_binding(v):
    """Host-canonical form of one parameter binding for fingerprinting —
    numpy/torch scalars and python numbers of equal value must agree."""
    if isinstance(v, bool):
        return repr(v)
    if isinstance(v, (int, np.integer)):
        return repr(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    try:                                  # 0-d torch/numpy array bindings
        return _canon_binding(v.item())
    except (AttributeError, ValueError):
        return repr(v)


def plan_fingerprint(nodes, bindings: dict | None = None) -> int:
    """Stable CONTENT fingerprint of a plan (walk order) plus its parameter
    bindings — keeps one store directory from serving another query's
    snapshots.

    Hashes the planner's canonical node serialization
    (:func:`repro_torch.core.planner.plan_signature`): node types, column names,
    join/group keys, aggregate ops, literals and parameter specs, and the
    exact child wiring.  The predecessor hashed only the node-type-name
    sequence, so every same-shaped query — and every binding of one plan
    template — collided, letting a resume adopt a different query's
    snapshots: a silent wrong answer.  Distinct ``bindings`` of one template
    are distinct fingerprints for the same reason."""
    text = _walk_signature(nodes)
    if bindings:
        text += "||" + ";".join(f"{k}={_canon_binding(v)}"
                                for k, v in sorted(bindings.items()))
    return int.from_bytes(
        hashlib.blake2b(text.encode(), digest_size=8).digest(), "big")


def _partition_key_of(node) -> str | None:
    """Hash-partition key of an exchange node's output; None = replicated
    (Broadcast) or gathered-to-all (GroupBy via gather) state."""
    if isinstance(node, qp.Shuffle):
        return node.key
    if isinstance(node, qp.GroupBy) and node.exchange == "shuffle":
        return node.keys[0] if node.keys else None
    return None


# ---------------------------------------------------------------------------
# stacked-layout re-sharding (the partition_database wire format)
# ---------------------------------------------------------------------------

ROWID = "__rowid"


def unshard(cols: dict, n: int) -> dict:
    """Stacked shard layout -> one global dict of the valid rows.

    ``cols`` mirrors :func:`repro_torch.core.backend.partition_database`
    output:
    data columns shaped ``(n*cap,)`` plus ``__count`` shaped ``(n,)``.
    Valid rows are concatenated in partition order; when a ``__rowid``
    anchor column is present the result is re-sorted (stably) to the
    original global order — that anchor is what makes :func:`reshard`
    round-trips byte-identical.  Replicated layouts (every shard holds the
    whole table) come back with ``n`` copies; callers that replicated with
    ``key=None`` should read shard 0 instead.
    """
    counts = np.asarray(cols["__count"]).astype(np.int64)
    if counts.shape != (n,):
        raise ValueError(f"__count shape {counts.shape} != ({n},)")
    data = {k: np.asarray(v) for k, v in cols.items() if k != "__count"}
    if not data:
        raise ValueError("no data columns to unshard")
    cap = next(iter(data.values())).shape[0] // n
    if np.any(counts > cap) or np.any(counts < 0):
        raise ValueError(f"counts {counts} exceed shard capacity {cap}")
    out = {name: np.concatenate([v[d * cap: d * cap + counts[d]]
                                 for d in range(n)])
           for name, v in data.items()}
    if ROWID in out:
        order = np.argsort(out[ROWID], kind="stable")
        out = {k: v[order] for k, v in out.items()}
    return out


def reshard(cols: dict, n_old: int, n_new: int, key: str | None,
            cap: int | None = None) -> dict:
    """Re-partition a stacked snapshot from ``n_old`` to ``n_new`` shards.

    The degraded-mesh primitive: rows are recovered in global order
    (see :func:`unshard`), re-assigned with the same splitmix64
    ``hash_partition_np`` the boot-time partitioner used, and re-stacked at
    the new width.  A ``__rowid`` anchor column is added on first contact
    and carried thereafter, so ``N -> N' -> N`` round-trips byte-identically
    — including masked/empty partitions, which zero-fill their padding just
    like :func:`repro_torch.core.backend.partition_database`.
    ``key=None``
    replicates the whole table into every shard (tiny dimension tables)."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    glob = unshard(cols, n_old)
    nrows = len(next(iter(glob.values())))
    if ROWID not in glob:
        glob[ROWID] = np.arange(nrows, dtype=np.int64)
    if key is None:
        shards = [glob] * n_new
    else:
        dest = B.hash_partition_np(np.asarray(glob[key]), n_new)
        shards = [{k: v[dest == d] for k, v in glob.items()}
                  for d in range(n_new)]
    longest = max(len(next(iter(s.values()))) for s in shards)
    if cap is None:
        cap = max(8, -(-longest // 8) * 8)
    elif longest > cap:
        raise ValueError(f"shard of {longest} rows exceeds cap {cap}")
    out = {}
    for name in glob:
        stacked = np.zeros((n_new * cap,), dtype=glob[name].dtype)
        for d, s in enumerate(shards):
            stacked[d * cap: d * cap + len(s[name])] = s[name]
        out[name] = stacked
    out["__count"] = np.array([len(next(iter(s.values()))) for s in shards],
                              dtype=np.int32)
    return out


class LineageStore:
    """Durable post-exchange tables, keyed by plan-walk ordinal.

    One directory per query; each snapshot is a ``checkpoint`` step whose
    flat dict holds the table columns plus ``__count`` / ``__valid``.
    ``reused`` counts snapshot hits since the last :meth:`begin_plan` —
    surfaced as ``snapshots_reused`` in the fault runner's RunReport.
    """

    def __init__(self, directory: str):
        self.dir = directory
        self.config: dict = {}
        self.reused = 0
        self.saved = 0
        self.resharded = 0

    # -- lifecycle ----------------------------------------------------------
    def begin_plan(self, config: dict) -> None:
        """Pins the configuration that snapshots written/read during this
        run must carry — snapshots from another leg are ignored, not mixed."""
        self.config = dict(config)
        self.reused = 0
        self.saved = 0
        self.resharded = 0

    def begin_executor(self, nodes, inference: bool,
                       wire_format: str | None,
                       bindings: dict | None = None,
                       n_devices: int = 1) -> None:
        """Called by ``planner._Executor.run`` (duck-typed: the core layer
        never imports this module) with the plan's walk order, the run's
        configuration legs, and the template parameter bindings (if any) —
        two bindings of one template must never exchange snapshots.
        ``n_devices`` is the logical mesh width the run targets; it is the
        ONE config axis a resume may differ on (see :meth:`load`)."""
        self.begin_plan({"plan": plan_fingerprint(nodes, bindings),
                         "inference": bool(inference),
                         "wire_format": wire_format,
                         "n_devices": int(n_devices)})

    def _width_only_mismatch(self, cfg) -> bool:
        """True when ``cfg`` differs from the pinned config ONLY in the
        logical device width — the topology-shrink resume case."""
        if not isinstance(cfg, dict) or cfg == self.config:
            return False
        a = {k: v for k, v in cfg.items() if k != "n_devices"}
        b = {k: v for k, v in self.config.items() if k != "n_devices"}
        return a == b

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    # -- executor interface -------------------------------------------------
    def load(self, tag: int, ctx):
        """Snapshot for plan node ``tag`` under the pinned config, on
        ``ctx``'s device, or None."""
        path = os.path.join(self.dir, f"step_{tag:010d}")
        if not os.path.isdir(path):
            return None
        try:
            flat, meta = ckpt.restore_flat(self.dir, tag, device=ctx.device)
        except (IOError, ValueError, OSError):
            return None          # torn/foreign snapshot: fall back to re-exec
        cfg = meta.get("config")
        if cfg != self.config:
            if not self._width_only_mismatch(cfg):
                return None      # other leg (inference/wire/plan): not ours
            # Topology shrink (N -> N'): snapshots are stored in
            # global row order, so the table itself is width-independent —
            # adopt it; downstream exchanges recompute the partition
            # assignment at N'.
            self.resharded += 1
        count = flat.pop("__count").reshape(()).to(torch.int32)
        valid = flat.pop("__valid", None)
        self.reused += 1
        return Table(flat, count, valid)

    def save(self, tag: int, table, ctx, node=None) -> None:
        """Persist a post-exchange table — only when it is durable state:
        overflow-free.
        ``node`` (the plan exchange node, when the executor passes it)
        contributes partition metadata — the shuffle key and targeted width
        — so out-of-band tooling can re-shard the snapshot explicitly."""
        if not isinstance(table, Table):
            return
        if bool(ctx.overflow):
            return               # overflowed state is not durable
        flat = dict(table.columns)
        flat["__count"] = table.count
        if table.valid is not None:
            flat["__valid"] = table.valid
        meta = {"keys": sorted(flat), "config": self.config}
        if node is not None:
            meta["partition"] = {
                "key": _partition_key_of(node),
                "n": int(self.config.get("n_devices", 1))}
        ckpt.save(self.dir, tag, flat, metadata=meta)
        self.saved += 1


def run_resumable(query_fn, db, store: LineageStore,
                  capacity_factor: float = 2.0, join_method: str = "sorted",
                  wire_format: str | None = None, chaos=None,
                  n_devices: int = 1,
                  device: str | torch.device | None = None,
                  ) -> tuple[dict, B.PlanStats, bool, int]:
    """One single-device attempt with lineage snapshots armed, on ``device``
    (``cuda`` unless the caller names another) over the database's
    resident tables.

    Returns ``(result, stats, overflow, snapshots_reused)`` — the fault
    runner's attempt signature.  A payload integrity failure raises
    :class:`CorruptPayload` exactly like the drivers in ``core.backend``.
    A resumed attempt's PlanStats cover only the re-executed suffix (skipped
    subtrees issue no exchanges).  ``n_devices`` is the logical width
    this attempt targets: it is pinned into the snapshot config
    (``ctx.lineage_devices``), so a post-shrink resume at N' re-adopts
    snapshots written at N through the store's re-shard path.
    """
    dev = resolve_device(device)
    ctx = B.LocalContext(db, B.device_tables(db, dev), dev,
                         capacity_factor=capacity_factor,
                         join_method=join_method, wire_format=wire_format)
    ctx.chaos = chaos
    ctx.lineage = store
    ctx.lineage_devices = int(n_devices)
    out = B.result_table(query_fn(ctx), dev)
    if bool(ctx.corrupt):
        raise CorruptPayload("resumable run: payload integrity check failed")
    return (to_numpy(out), ctx.stats, bool(ctx.overflow), store.reused)
