"""Multi-tenant serving: prepare-once-per-template execution + batch sharing.

Two execution paths, one correctness story:

  * :class:`QueryServer` — the prepared path.  Each template is prepared
    ONCE per (database, configuration): its ``PlanInfo`` (host-side,
    domain-sound for every admissible binding), its plan and the context's
    settings, closed over by a ``run(tables, pvals)`` that builds a fresh
    ``LocalContext`` and executor per call.  The engine is eager, so there
    is no trace to reuse; the preparation is what every request would
    otherwise redo.  Parameter bindings enter as dtype-pinned 0-d tensors
    on the server's device, so a Python int bound to a float64 parameter
    never changes a column's dtype and no binding is read back to the
    host: serving a new binding is a cache hit and a device run.
    ``recompiles`` counts preparations (incremented inside the builder, so
    an accidental re-preparation — a key drifting with the binding — is
    counted).  Prepared templates live in a
    :class:`repro_torch.serve.cache.PlanCache`, so ``invalidate_stats`` /
    ``stats_override`` / table mutation evict them with the statistics they
    were derived from.  A served request whose domain-derived claims prove
    too tight for its binding surfaces as ``ctx.overflow``; the server
    re-runs it on a conservative entry (inference off, escalated capacity,
    its own cache key) — degraded latency, never a wrong answer.
  * :class:`BatchExecutor` — the batch path.  Admits N bound queries and
    extends the planner executor's per-plan DAG memo into a CROSS-QUERY
    memo keyed by (subtree content hash, relevant bindings): scans and
    common subplans — every query touching ``lineitem``, Q3/Q5 sharing a
    filtered-orders fragment — execute once per batch.  Results are
    byte-identical to running each request alone (pinned by
    ``tests/test_torch_serve.py`` on both planner and both wire legs, and
    on the card by ``chip_smoke.py``); an overflowing request forfeits its
    memo contributions and re-runs conservatively in isolation, so a lying
    bound can never poison a neighbour.  The memo holds every memoized
    subplan of the batch until it ends, unbounded, as in the reference.

Both hold the database's resident device tables
(:func:`repro_torch.core.backend.device_tables`, the one upload ``run_local``
shares), taken at construction: a server built before a table mutation
keeps serving the tensors it was built with.  They run on ``cuda`` unless
the caller names another device, and raise where CUDA is absent.

Topology awareness: the server carries a logical device width and a
monotonically increasing ``topology_generation``.  Losing devices
(:meth:`QueryServer.degrade`) bumps the generation — which is part of the
executable cache key, so every template is re-prepared exactly ONCE per
(template, generation), never per request — and re-prices the per-device
footprint.  With an :class:`AdmissionGate` configured,
:meth:`QueryServer.submit_guarded` returns structured outcomes instead of
opaque errors: :class:`Served` (full-width topology), :class:`Degraded`
(answered, but on a shrunken topology), or :class:`Shed` (declined or
queued because the estimated per-device footprint no longer fits the
degraded cluster; queued requests re-admit via :meth:`drain_backlog`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import backend as B
from repro_torch.core import planner
from repro_torch.core.table import resolve_device, to_numpy
from repro_torch.core.wire import CorruptPayload
from .cache import PlanCache
from .templates import BoundQuery, PlanTemplate, TEMPLATES

__all__ = ["QueryServer", "BatchExecutor", "AdmissionGate",
           "Served", "Degraded", "Shed"]

_PDTYPE = {"int64": torch.int64, "float64": torch.float64}


def _read_flag(flag: torch.Tensor) -> bool:
    """A run's 0-d overflow or corrupt flag, read on the host."""
    with tracing.sync("flags"):
        return bool(flag)


@dataclasses.dataclass(frozen=True)
class AdmissionGate:
    """Per-device memory budget for admission control.

    ``hbm_bytes`` is the accelerator memory per device; a request is
    admitted while the server's estimated per-device footprint — database
    partition plus capacity-scaled working buffers — stays within
    ``headroom * hbm_bytes``.  After a topology shrink N -> N' the
    footprint grows by N/N', which is exactly what pushes oversized
    requests into :class:`Shed`."""
    hbm_bytes: float
    headroom: float = 0.8

    @property
    def budget_bytes(self) -> float:
        return self.headroom * self.hbm_bytes


@dataclasses.dataclass
class Served:
    """Request answered on the full-width (boot) topology."""
    name: str
    result: dict
    devices: int
    generation: int = 0


@dataclasses.dataclass
class Degraded:
    """Request answered correctly, but on a shrunken topology — the caller
    sees degraded capacity/latency, never a degraded answer."""
    name: str
    result: dict
    devices: int
    generation: int
    lost: int = 0                 # devices below boot width


@dataclasses.dataclass
class Shed:
    """Request NOT executed: its estimated footprint does not fit the
    current (degraded) cluster.  ``queued`` means it sits in the server
    backlog and re-admits via :meth:`QueryServer.drain_backlog` once
    capacity returns."""
    name: str
    reason: str
    estimated_bytes: float
    budget_bytes: float
    devices: int
    generation: int
    queued: bool = False


class QueryServer:
    """Serve parameterized queries from prepared template executables."""

    def __init__(self, db, capacity_factor: float = 2.0,
                 join_method: str = "sorted",
                 wire_format: str | None = None,
                 cache: PlanCache | None = None,
                 devices: int = 1, gate: AdmissionGate | None = None,
                 device: str | torch.device | None = None):
        self.db = db
        self.device = resolve_device(device)
        self.capacity_factor = capacity_factor
        self.join_method = join_method
        self.wire_format = wire_format
        self.cache = cache if cache is not None else PlanCache()
        self.recompiles = 0          # preparations (counted in the builder)
        self.cache_hits = 0
        self.overflow_reruns = 0
        self.approx_served = 0       # answers served off a sample rung
        self.approx_escalations = 0  # tolerance misses climbed past
        self.approx_refused = 0      # non-estimable shapes served exact
        self._seq = itertools.count(1)   # a request's number in its spans
        self._tables = B.device_tables(db, self.device)
        # topology state: logical width this server answers on behalf of
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.boot_devices = int(devices)
        self.devices = int(devices)
        self.topology_generation = 0
        self.gate = gate
        self.shed_count = 0
        self.backlog: list[tuple[PlanTemplate, dict | None, bool | None]] = []
        self._db_bytes = float(sum(
            np.asarray(col).nbytes
            for t in db.tables.values() for col in t.values()))

    # -- topology -----------------------------------------------------------
    def degrade(self, devices: int) -> int:
        """Shrink the logical topology to ``devices`` survivors.  Bumps the
        topology generation — every template is re-prepared exactly once
        against the new generation (the generation is in the executable
        cache key).  Returns the new generation."""
        if not 1 <= devices <= self.devices:
            raise ValueError(
                f"degrade to {devices} from {self.devices} devices")
        if devices != self.devices:
            self.devices = int(devices)
            self.topology_generation += 1
        return self.topology_generation

    def restore(self, devices: int | None = None) -> int:
        """Recovered capacity (default: back to boot width).  A new
        generation as well — the topology changed."""
        devices = self.boot_devices if devices is None else int(devices)
        if devices < 1:
            raise ValueError(f"restore to {devices} devices")
        if devices != self.devices:
            self.devices = devices
            self.topology_generation += 1
        return self.topology_generation

    def footprint_bytes(self, factor: float | None = None) -> float:
        """Estimated per-device footprint at the live width: the device's
        database partition plus exchange/join working buffers, which the
        engine sizes as ``capacity_factor`` x the partition."""
        factor = self.capacity_factor if factor is None else factor
        return self._db_bytes / self.devices * (1.0 + float(factor))

    def _cached(self, key, build):
        """The cache's entry for ``key`` on this server's database, built
        (and stored) on a miss; a hit is counted."""
        got = self.cache.get(self.db, key)
        if got is None:
            got = build()
            self.cache.put(self.db, key, got)
        else:
            self.cache_hits += 1
        return got

    def _prepare(self, query, db, infer: bool, factor: float):
        """Prepare ``query`` against ``db`` once: its PlanInfo, plan and
        context settings, closed over by ``run(tables, pvals)``, which
        executes it with a fresh context and returns the device result
        Table and the overflow and corrupt flags (0-d device tensors)."""
        self.recompiles += 1
        with tracing.span("serve.prepare"):
            info = query.info(db) if infer else None
        plan, device = query.plan, self.device
        settings = dict(capacity_factor=factor, join_method=self.join_method,
                        wire_format=self.wire_format)

        def run(tables, pvals):
            ctx = B.LocalContext(db, tables, device, **settings)
            out = planner._Executor(ctx, info, params=pvals).run(plan)
            return B.result_table(out, device), ctx.overflow, ctx.corrupt

        return run

    def _config(self, infer: bool, factor: float) -> tuple:
        return (bool(infer), self.wire_format, float(factor),
                self.join_method, str(self.device), self.topology_generation)

    def _executable(self, template: PlanTemplate, infer: bool, factor: float):
        key = ("exe", template.signature()) + self._config(infer, factor)
        return self._cached(key, lambda: self._prepare(
            template.query, self.db, infer, factor))

    def _pvals(self, template: PlanTemplate, values: dict) -> dict:
        """A binding as 0-d tensors of each parameter's pinned dtype on the
        server's device; every declared parameter is always present."""
        out = {}
        for name, v in values.items():
            with tracing.sync("param"):
                out[name] = torch.tensor(v, dtype=_PDTYPE[
                    template.params[name].dtype], device=self.device)
        return out

    def submit(self, template: PlanTemplate | int,
               bindings: dict[str, Any] | None = None,
               infer: bool | None = None,
               tolerance: float | None = None,
               confidence: float = 0.95) -> dict:
        """Execute one parameterized request; returns the numpy result.

        ``tolerance=`` opts into approximate serving: the answer comes from
        the smallest sample rung whose relative CI half-width (at
        ``confidence``) fits the tolerance, escalating up the ladder
        otherwise — each rung a separately-cached executable (the rung is in
        the cache key, so approximate and exact artifacts never collide).
        Plans the rewrite pass refuses run exact.  Default tolerance comes
        from ``REPRO_APPROX`` (unset = exact serving).
        """
        if isinstance(template, int):
            template = TEMPLATES[template]
        with tracing.span("serve.submit", template.name, next(self._seq)):
            if infer is None:
                infer = planner.planner_default()
            with tracing.span("serve.bind"):
                bound = template.bind(**(bindings or {}))
                pvals = self._pvals(template, bound.values)
            if tolerance is None:
                from repro_torch.approx.progressive import approx_default
                tolerance = approx_default()
            if tolerance is not None:
                res = self._submit_approx(template, pvals, infer,
                                          float(tolerance), confidence)
                if res is not None:
                    return res
                self.approx_refused += 1
            fn = self._executable(template, infer, self.capacity_factor)
            out = self._run_checked(
                fn, self._tables, pvals, template.name,
                lambda: self._executable(template, False,
                                         self.capacity_factor * 4.0))
            with tracing.span("serve.fetch"):
                return to_numpy(out)

    def _run_checked(self, fn, tables, pvals, name, conservative):
        """Run a prepared executable; on overflow re-run it on the
        ``conservative()`` entry (no hints, escalated capacity, full-width
        wire — its own cache key, so healthy traffic keeps the fast entry).
        Raises on a payload integrity failure and on a persisting
        overflow."""
        with tracing.span("serve.execute"):
            out, overflow, corrupt = fn(tables, pvals)
        if _read_flag(overflow):
            self.overflow_reruns += 1
            with tracing.span("serve.rerun"):
                out, overflow, corrupt = conservative()(tables, pvals)
        if _read_flag(corrupt):
            raise CorruptPayload("serve: payload integrity check failed")
        if _read_flag(overflow):
            raise RuntimeError(
                f"{name}: overflow persists on the conservative rerun "
                f"(capacity_factor={self.capacity_factor * 4.0})")
        return out

    # -- approximate serving (repro_torch.approx) --------------------------
    def _approx_rewrite(self, template: PlanTemplate, den: int):
        """Rung rewrite of a template, cached (and invalidated) with the
        statistics it was derived from."""
        from repro_torch.approx import rewrite as AR
        from repro_torch.approx import sampling as AS
        key = ("approx-rw", template.signature(), int(den), AS.DEFAULT_SEED)
        return self._cached(key, lambda: (
            "rw", AR.rewrite_for_rung(template.query, self.db, den)))[1]

    def _approx_executable(self, template: PlanTemplate, rw, infer: bool,
                           factor: float):
        """The rung's prepared executable and its device tables: the base's
        resident tensors plus the one sample table."""
        from repro_torch.approx import sampling as AS
        tkey = ("approx-tables", rw.table, rw.strata, int(rw.den),
                AS.DEFAULT_SEED)
        tables = self.cache.get(self.db, tkey)
        if tables is None:
            tables = B.device_tables(rw.db, self.device)
            self.cache.put(self.db, tkey, tables)
        # the rung is part of the key: approximate and exact executables
        # (and different rungs) never collide in the cache
        key = ("exe-approx", template.signature(), int(rw.den)) + \
            self._config(infer, factor)
        fn = self._cached(key, lambda: self._prepare(
            rw.query, rw.db, infer, factor))
        return fn, tables

    def _submit_approx(self, template: PlanTemplate, pvals: dict,
                       infer: bool, tolerance: float,
                       confidence: float) -> dict | None:
        """Climb the sample ladder; None means the shape refused (go exact)."""
        from repro_torch.approx import sampling as AS
        for den in AS.LADDER:
            rw = self._approx_rewrite(template, den)
            if rw is None:
                return None
            fn, tables = self._approx_executable(
                template, rw, infer, self.capacity_factor)
            out = self._run_checked(
                fn, tables, pvals, f"{template.name}~r{den}",
                lambda: self._approx_executable(
                    template, rw, False, self.capacity_factor * 4.0)[0])
            est = rw.finalize(to_numpy(out), confidence)
            if est.rel_width <= tolerance or den == 1:
                self.approx_served += 1
                return est.result
            self.approx_escalations += 1
        return None    # unreachable: the den == 1 rung always answers

    def serve(self, requests, infer: bool | None = None,
              tolerance: float | None = None) -> list[dict]:
        """Submit a stream of ``(template_or_qid, bindings)`` requests."""
        return [self.submit(t, b, infer=infer, tolerance=tolerance)
                for t, b in requests]

    # -- capacity-aware admission ------------------------------------------
    def submit_guarded(self, template: PlanTemplate | int,
                       bindings: dict[str, Any] | None = None,
                       infer: bool | None = None,
                       queue: bool = True) -> Served | Degraded | Shed:
        """Admission-gated submit with structured outcomes.

        With no :class:`AdmissionGate` configured every request is admitted.
        Otherwise a request whose estimated per-device footprint exceeds the
        gate's budget at the LIVE width is not executed: it is queued on the
        server backlog (``queue=True``, the default) or declined outright —
        both surfaced as :class:`Shed`, never as an opaque error.  Admitted
        requests on a shrunken topology come back :class:`Degraded`."""
        if isinstance(template, int):
            template = TEMPLATES[template]
        if self.gate is not None:
            est = self.footprint_bytes()
            if est > self.gate.budget_bytes:
                self.shed_count += 1
                if queue:
                    self.backlog.append((template, bindings, infer))
                return Shed(
                    name=template.name, queued=queue,
                    reason=(f"estimated per-device footprint "
                            f"{est / 1e6:.1f} MB exceeds budget "
                            f"{self.gate.budget_bytes / 1e6:.1f} MB at "
                            f"{self.devices} devices"),
                    estimated_bytes=est,
                    budget_bytes=self.gate.budget_bytes,
                    devices=self.devices,
                    generation=self.topology_generation)
        result = self.submit(template, bindings, infer=infer)
        if self.devices < self.boot_devices:
            return Degraded(name=template.name, result=result,
                            devices=self.devices,
                            generation=self.topology_generation,
                            lost=self.boot_devices - self.devices)
        return Served(name=template.name, result=result,
                      devices=self.devices,
                      generation=self.topology_generation)

    def drain_backlog(self) -> list[Served | Degraded | Shed]:
        """Re-admit queued requests (after :meth:`restore` or a capacity
        change).  Requests that still do not fit go back on the backlog."""
        pending, self.backlog = self.backlog, []
        return [self.submit_guarded(t, b, infer=i, queue=True)
                for t, b, i in pending]


class _SharedMemoExecutor(planner._Executor):
    """Planner executor whose node memo extends across queries.

    Key = (subtree content hash, the bindings of the parameters that subtree
    can observe, inference leg).  Content-addressing makes distinct plan
    objects with identical logical subtrees share; restricting the key to
    the REACHABLE parameters lets two bindings share every subtree that
    doesn't depend on where they differ (all scans, for one).  Sound because
    per-subtree planner decisions (hints, wire bounds) depend only on the
    subtree's content and the database statistics — identical key, identical
    table."""

    def __init__(self, ctx, info, params, subsigs, shared, added, owner):
        super().__init__(ctx, info, params=params)
        self._subsigs = subsigs
        self._shared = shared
        self._added = added
        self._owner = owner

    def _exec(self, node):
        got = self.memo.get(id(node))
        if got is not None:
            return got
        sig, pnames = self._subsigs[id(node)]
        key = (sig, tuple(sorted((p, self.params.get(p)) for p in pnames)),
               self.info is not None)
        out = self._shared.get(key)
        if out is not None:
            self._owner.shared_hits += 1
            self.memo[id(node)] = out
            return out
        out = super()._exec(node)    # recursion re-enters this override
        self._shared[key] = out
        self._added.append(key)
        return out


class BatchExecutor:
    """Execute a batch of bound queries with cross-query sharing."""

    def __init__(self, db, capacity_factor: float = 2.0,
                 join_method: str = "sorted",
                 wire_format: str | None = None,
                 device: str | torch.device | None = None):
        self.db = db
        self.device = resolve_device(device)
        self.capacity_factor = capacity_factor
        self.join_method = join_method
        self.wire_format = wire_format
        self.shared_hits = 0         # cross-query memo hits
        self.overflow_reruns = 0
        self._tables = B.device_tables(db, self.device)

    def _ctx(self, factor: float):
        return B.LocalContext(self.db, self._tables, self.device,
                              capacity_factor=factor,
                              join_method=self.join_method,
                              wire_format=self.wire_format)

    def run_batch(self, requests, infer: bool | None = None) -> list[dict]:
        """``requests``: (template, bindings) pairs (or BoundQuery directly).

        Returns per-request numpy results, byte-identical to running each
        request alone in submission order.
        """
        if infer is None:
            infer = planner.planner_default()
        shared: dict = {}
        ctx = self._ctx(self.capacity_factor)
        results: list[dict] = []
        for req in requests:
            bound = req if isinstance(req, BoundQuery) else \
                req[0].bind(**(req[1] or {}))
            template = bound.template
            info = template.query.info(self.db) if infer else None
            added: list = []
            ex = _SharedMemoExecutor(ctx, info, bound.values,
                                     template.subplan_signatures(), shared,
                                     added, self)
            out = B.result_table(ex.run(template.query.plan), self.device)
            if _read_flag(ctx.corrupt):
                raise CorruptPayload(
                    "batch: payload integrity check failed")
            if _read_flag(ctx.overflow):
                # this request's claims lied: its memo contributions are not
                # trustworthy state — forfeit them, re-run the request alone
                # conservatively, and start the NEXT request on a fresh
                # context (the overflow flag is sticky by design)
                for k in added:
                    shared.pop(k, None)
                results.append(self._conservative(bound))
                ctx = self._ctx(self.capacity_factor)
                continue
            results.append(to_numpy(out))
        return results

    def _conservative(self, bound: BoundQuery) -> dict:
        self.overflow_reruns += 1
        ctx = self._ctx(self.capacity_factor * 4.0)
        out = B.result_table(bound.with_inference(False)(ctx), self.device)
        if _read_flag(ctx.corrupt):
            raise CorruptPayload("batch: payload integrity check failed")
        if _read_flag(ctx.overflow):
            raise RuntimeError(
                f"{bound.template.name}: overflow persists on the "
                f"conservative rerun")
        return to_numpy(out)
