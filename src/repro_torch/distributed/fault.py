"""Fault tolerance + skew mitigation for distributed queries.

Queries: the paper's model (§2.4) — re-execution at interactive speed —
extended with a failure TAXONOMY
(:class:`repro_torch.distributed.chaos.FailureKind`) so the runner reacts to what actually went wrong instead of retrying blindly:

  TRANSIENT      environment fault (node loss, flaky link, timeout): retry
                 with bounded exponential backoff (:class:`RetryPolicy`).
  OVERFLOW       structured capacity failure (a shuffle bucket, a shrink, a
                 hash-join bucket table, a narrowed wire lane, or the hash-
                 aggregation dictionary exceeded its planned size — all raise
                 ``ctx.overflow``, never assert locally): escalate the
                 capacity factor; after a second overflow, recompile with
                 inference dropped (no hints -> no hint-induced overflow).
                 The factor also scales the hash-join per-bucket capacity
                 (``_BaseContext.bucket_cap``) AND the group-by dictionary
                 (``relational.group_aggregate(method="hash")`` sizes it
                 ``groups_hint * factor``), so escalation genuinely enlarges
                 both.
  CORRUPT        a packed payload failed its wire integrity checksum
                 (:class:`repro_torch.core.wire.CorruptPayload`): re-run on
                 the conservative wide format — never serve the bad buffer.
  DETERMINISTIC  a plan-author bug (TypeError, ValueError, assertion …):
                 raised immediately on attempt 1 — re-execution cannot fix
                 code.
  DEVICE_LOST    one or more ranks are permanently dead
                 (:class:`repro_torch.distributed.chaos.DeviceLost`):
                 retrying on the same topology can only fail again.  The
                 runner shrinks the rank group to the survivors
                 (:func:`surviving_group`), drops the old width's shards
                 from the device, bumps its topology generation, re-derives
                 the perf-model budgets at the new width
                 (``ClusterSpec.with_devices`` — Hockney / Eq. 3 pricing
                 uses N', not the boot-time N), re-plans and re-executes.
                 ``run_distributed`` re-partitions the database over the
                 surviving N' ranks, so per-rank capacity grows by N/N'
                 automatically; with a lineage store armed, snapshots
                 written at width N are re-sharded onto N' instead of
                 discarded.

Each attempt is logged in a :class:`RunReport` (failure kind, chaos cut
point, backoff, snapshot reuse, live device count, topology generation);
the seeded chaos harness (:mod:`repro_torch.distributed.chaos`,
``REPRO_CHAOS`` env) drives every branch of this policy deterministically.

Skew: the monitor computes the paper's §3.5 statistic (per-node send/recv max
over mean) from exchange recv-counts; the planner consults Eq. 3 to pick
broadcast vs shuffle given table sizes, and hot-key salting splits dominant
keys before a grouped shuffle (local pre-aggregation already bounds
per-key payload — salting bounds residual placement skew).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core import perfmodel as pm
from repro_torch.core.table import resolve_device
from repro_torch.core.wire import CorruptPayload
from .chaos import (ChaosInjector, DeviceLost, FailureKind, FiredFault,
                    _mix, resolve_lost)

__all__ = [
    "QueryRunner", "RunResult", "RunReport", "AttemptReport", "RetryPolicy",
    "FailureKind", "QueryTimeout", "classify_failure", "surviving_group",
    "choose_exchange", "skew_imbalance", "salt_hot_keys",
]


# exception types that indicate a bug in plan/query code, not the
# environment: re-executing is useless and masks the error — raise on
# attempt 1 (the old catch-all burned max_attempts re-runs on these)
_DETERMINISTIC_EXC = (TypeError, ValueError, KeyError, IndexError,
                      AttributeError, AssertionError, NameError,
                      ZeroDivisionError)


def classify_failure(exc: BaseException) -> FailureKind:
    """Map a raised exception onto the failure taxonomy.

    ``CorruptPayload`` -> CORRUPT; plan-author bug types -> DETERMINISTIC;
    everything else (``TransientFault``, OSError, timeouts, the unknown) is
    treated as a TRANSIENT environment fault and retried — the conservative
    default, bounded by ``RetryPolicy.max_attempts``.
    """
    if isinstance(exc, DeviceLost):
        return FailureKind.DEVICE_LOST
    if isinstance(exc, CorruptPayload):
        return FailureKind.CORRUPT
    if isinstance(exc, _DETERMINISTIC_EXC):
        return FailureKind.DETERMINISTIC
    return FailureKind.TRANSIENT


class QueryTimeout(RuntimeError):
    """The runner's OVERALL wall-clock deadline (``QueryRunner.deadline_s``)
    expired with attempts still in the budget.  Distinct from the
    per-attempt straggler deadline (``RetryPolicy.deadline_s``), which
    discards one late attempt; this one ends the query.  Carries the
    partial :class:`RunReport` so the caller can audit what was tried."""

    def __init__(self, message: str, report: "RunReport"):
        super().__init__(message)
        self.report = report


def surviving_group(group, lost: tuple[int, ...]):
    """A rank group of every rank of ``group`` except the ``lost`` ones.

    For a :class:`~repro_torch.core.comm.ThreadGroup` that is a smaller
    ThreadGroup on the same device: its ranks renumber 0..N'-1 in the
    survivors' order, which is all the engine needs (it re-partitions the
    database over N').  A ``TorchDistGroup`` spans processes, and shrinking
    it needs a new process group over the survivors on a host with several
    cards, which is not yet done (ROADMAP queue A, item 6)."""
    if isinstance(group, comm.TorchDistGroup):
        raise NotImplementedError(
            "surviving_group: shrinking a TorchDistGroup across processes is "
            "not ported (ROADMAP A6: needs a host with several cards)")
    survivors = [r for r in range(group.size) if r not in set(lost)]
    if not survivors:
        raise ValueError(f"no survivors: lost {lost!r} of {group.size} ranks")
    return comm.ThreadGroup(len(survivors), group.device)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and an optional per-attempt
    deadline.

    ``deadline_s``: an attempt whose wall time exceeds it is treated as a
    straggler — its (correct) result is discarded and the query re-executes,
    the speculative-retry semantics of §2.4 (never applied to the final
    attempt: a late answer beats none).

    ``jitter``: with it on, :meth:`backoff` applies seeded decorrelated
    jitter — pure exponential backoff synchronizes the retry storms of
    concurrent runners that failed together.  The jitter is derived from a
    seed (the runner passes the chaos seed, or ``seed`` here), so chaos
    runs stay bit-deterministic; it is bounded to
    ``[backoff_s, max_backoff_s]``.
    """
    max_attempts: int = 4
    backoff_s: float = 0.05       # first TRANSIENT retry waits this long
    backoff_mult: float = 2.0     # then doubles ...
    max_backoff_s: float = 2.0    # ... up to this cap
    deadline_s: float | None = None
    jitter: bool = False          # seeded decorrelated jitter on backoff
    seed: int | None = None       # jitter seed override (else: chaos seed)

    def backoff(self, transient_failures: int,
                seed: int | None = None) -> float:
        """Sleep before the next attempt after the n-th transient failure.

        Without ``jitter`` (or with no seed available): bounded exponential,
        exactly ``backoff_s * mult^(n-1)`` capped at ``max_backoff_s``.
        With it: decorrelated jitter — uniform (seeded, deterministic) in
        ``[backoff_s, min(max_backoff_s, 3 * previous_sleep)]`` — each
        runner's sequence de-synchronizes from its neighbours' while keeping
        the same bounds."""
        exp = min(self.backoff_s * self.backoff_mult
                  ** (transient_failures - 1), self.max_backoff_s)
        seed = self.seed if self.seed is not None else seed
        if not self.jitter or seed is None:
            return exp
        prev = self.backoff(transient_failures - 1, seed) \
            if transient_failures > 1 else self.backoff_s
        hi = min(self.max_backoff_s, max(self.backoff_s, 3.0 * prev))
        u = (_mix(seed, "backoff", transient_failures) % 65536) / 65535.0
        return self.backoff_s + u * (hi - self.backoff_s)


@dataclasses.dataclass
class AttemptReport:
    """One row of the per-attempt audit trail."""
    attempt: int
    outcome: str                  # "ok" | FailureKind value
    wall_s: float
    capacity_factor: float
    wire_format: str | None
    inference: bool
    backoff_s: float = 0.0        # slept AFTER this attempt
    cut: str | None = None        # chaos cut point, when injected
    snapshots_reused: int = 0     # lineage: exchange snapshots resumed from
    error: str = ""
    devices: int = 0              # live width (ranks) this attempt ran on
    generation: int = 0           # topology generation (0 = boot group)
    rung: int = 0                 # approx ladder denominator (0 = exact plan)
    ci_width: float | None = None  # rel. CI half-width of an approx answer


@dataclasses.dataclass
class RunReport:
    """Full audit of one ``QueryRunner.run``: every attempt + every fault the
    chaos harness injected."""
    attempts: list[AttemptReport] = dataclasses.field(default_factory=list)
    injected: list[FiredFault] = dataclasses.field(default_factory=list)

    def outcomes(self) -> list[str]:
        return [a.outcome for a in self.attempts]

    def rows(self) -> list[dict]:
        return [dataclasses.asdict(a) for a in self.attempts]


@dataclasses.dataclass
class RunResult:
    result: dict
    stats: B.PlanStats
    attempts: int
    capacity_factor: float
    wall_s: float
    report: RunReport = dataclasses.field(default_factory=RunReport)


class QueryRunner:
    """Policy-driven re-execution (paper §2.4 fault tolerance + taxonomy).

    ``group`` is what ``run_distributed`` takes — a rank group
    (:mod:`repro_torch.core.comm`) or a rank count N, which means a
    ``ThreadGroup`` of N ranks on ``device`` — or None for the single-device
    path (``run_local`` on ``device``).  ``device`` is ``cuda`` unless the
    caller names another.  ``chaos``: a :class:`ChaosInjector` armed for
    every attempt (defaults to the ``REPRO_CHAOS`` env leg — unset means no
    injection).  ``lineage``: a
    :class:`repro_torch.distributed.lineage.LineageStore`; when given,
    attempts execute on the single-device engine persisting every exchange
    boundary, so a mid-query failure resumes from the last durable exchange
    instead of re-executing the whole plan (the distributed engine keeps
    the paper's whole-query re-execution).
    """

    def __init__(self, db, group=None, capacity_factor: float = 2.0,
                 max_attempts: int = 4, escalation: float = 2.0,
                 packed_exchange: bool = True, join_method: str = "sorted",
                 wire_format: str | None = None,
                 policy: RetryPolicy | None = None,
                 chaos: ChaosInjector | None = None,
                 lineage=None, deadline_s: float | None = None,
                 cluster: pm.ClusterSpec | None = None,
                 device: str | torch.device | None = None):
        self.db = db
        if isinstance(group, int):
            group = comm.ThreadGroup(group, device)
        self.group = group
        self.device = group.device if group is not None \
            else resolve_device(device)
        self.capacity_factor = capacity_factor
        self.escalation = escalation
        self.packed = packed_exchange
        self.join_method = join_method
        self.wire_format = wire_format
        self.policy = policy or RetryPolicy(max_attempts=max_attempts)
        self.chaos = chaos if chaos is not None else ChaosInjector.from_env()
        self.lineage = lineage
        self.deadline_s = deadline_s          # overall wall-clock budget
        self.cluster = cluster                # perf-model spec, kept at N'
        self.topology_generation = 0
        self.lost_devices: tuple[int, ...] = ()

    @property
    def devices(self) -> int:
        """Live width (N' after topology shrinks, N at boot)."""
        return self.group.size if self.group is not None else 1

    def _jitter_seed(self) -> int | None:
        if self.policy.seed is not None:
            return self.policy.seed
        return self.chaos.plan.seed if self.chaos is not None else None

    def _shrink_topology(self, exc: DeviceLost) -> tuple[int, ...]:
        """The topology-elastic rung: drop the dead ranks, re-derive the
        group over the survivors, free the old width's shards on the
        device (the dead ranks' memory is gone in the cluster this models),
        bump the generation, and re-scale the perf-model budgets to the new
        width.  Returns the resolved dead ranks (empty when nothing can
        shrink — a 1-rank group or the single-device path)."""
        world = self.devices
        lost = resolve_lost(exc, world)
        if not lost or self.group is None:
            return ()
        self.group = surviving_group(self.group, lost)
        B.release_shards(self.db, self.device, world)
        self.topology_generation += 1
        self.lost_devices = self.lost_devices + lost
        if self.cluster is not None:
            # Hockney / Eq. 3 pricing must see N', not the boot-time N
            self.cluster = self.cluster.with_devices(self.devices)
        return lost

    def _attempt(self, fn, factor: float, wire_format: str | None):
        """Execute one attempt; returns (result, stats, overflow, reused)."""
        if self.lineage is not None:
            from . import lineage as ln
            return ln.run_resumable(
                fn, self.db, self.lineage, capacity_factor=factor,
                join_method=self.join_method, wire_format=wire_format,
                chaos=self.chaos, n_devices=self.devices, device=self.device)
        if self.group is None:
            # single-device execution under the SAME policy loop — overflow
            # is returned, not raised, so capacity escalation still works
            result, stats, overflow = B.run_local(
                fn, self.db, capacity_factor=factor,
                join_method=self.join_method, wire_format=wire_format,
                chaos=self.chaos, return_overflow=True, device=self.device)
            return result, stats, overflow, 0
        result, stats, overflow = B.run_distributed(
            fn, self.db, self.group, capacity_factor=factor,
            packed_exchange=self.packed, join_method=self.join_method,
            wire_format=wire_format, chaos=self.chaos)
        return result, stats, overflow, 0

    def run(self, query_fn, bindings: dict | None = None) -> RunResult:
        """Execute ``query_fn`` under the retry policy.

        ``query_fn`` may be a plain ``fn(ctx)``, a compiled query, or a
        parameterized plan template (``repro_torch.serve.PlanTemplate``); in
        the template case pass the parameter values as ``bindings`` — they
        are bound ONCE here (domain-validated at bind time) and every retry,
        capacity escalation and hint-drop recompilation reuses the same
        bound query, so recovery can never silently change the answer the
        caller asked for."""
        if bindings is not None:
            if not hasattr(query_fn, "bind"):
                raise TypeError(
                    "bindings= requires a parameterized plan template "
                    "(repro_torch.serve.PlanTemplate); got "
                    f"{type(query_fn).__name__}")
            query_fn = query_fn.bind(**bindings)
        policy = self.policy
        factor = self.capacity_factor
        wire_format = self.wire_format
        fn = query_fn
        report = RunReport()
        overflow_failures = transient_failures = 0
        t_start = time.perf_counter()
        for attempt in range(1, policy.max_attempts + 1):
            if self.deadline_s is not None and attempt > 1 and \
                    time.perf_counter() - t_start > self.deadline_s:
                raise QueryTimeout(
                    f"overall deadline {self.deadline_s:.3f}s exceeded "
                    f"after {attempt - 1} attempts "
                    f"({time.perf_counter() - t_start:.3f}s)", report)
            if self.chaos is not None:
                self.chaos.begin_attempt(attempt)
            inference = getattr(fn, "_infer", True) is not False
            rep = AttemptReport(attempt=attempt, outcome="ok", wall_s=0.0,
                                capacity_factor=factor,
                                wire_format=wire_format, inference=inference,
                                devices=self.devices,
                                generation=self.topology_generation)
            report.attempts.append(rep)
            t0 = time.perf_counter()
            try:
                result, stats, overflow, reused = self._attempt(
                    fn, factor, wire_format)
            except Exception as exc:
                rep.wall_s = time.perf_counter() - t0
                rep.error = f"{type(exc).__name__}: {exc}"
                kind = classify_failure(exc)
                rep.outcome = kind.value
                self._note_injected(report)
                if kind is FailureKind.DETERMINISTIC:
                    raise            # a bug: surface on attempt 1, no retries
                if attempt >= policy.max_attempts:
                    raise
                if kind is FailureKind.DEVICE_LOST:
                    # topology-elastic rung: shrink to the survivors and
                    # re-execute — the database re-partitions over N', and
                    # the planner re-derives its analysis for the re-run
                    # (statistics and key_bits are width-invariant; the
                    # per-device budgets re-price through the cluster spec)
                    lost = self._shrink_topology(exc)
                    if not lost:
                        raise    # 1 rank: no survivors to shrink onto
                    rep.error += (f" [lost {list(lost)} -> "
                                  f"{self.devices} devices]")
                    replan = getattr(fn, "info", None)
                    if callable(replan):
                        replan(self.db)
                elif kind is FailureKind.CORRUPT:
                    # never trust the failed buffer: conservative format
                    wire_format = "wide"
                else:                # TRANSIENT: bounded backoff
                    transient_failures += 1
                    rep.backoff_s = policy.backoff(
                        transient_failures, seed=self._jitter_seed())
                    time.sleep(rep.backoff_s)
                continue
            rep.wall_s = time.perf_counter() - t0
            rep.snapshots_reused = reused
            self._note_injected(report)
            if overflow:
                rep.outcome = FailureKind.OVERFLOW.value
                if attempt >= policy.max_attempts:
                    break
                factor *= self.escalation   # bigger buffers on re-execution
                overflow_failures += 1
                if overflow_failures >= 2 and \
                        hasattr(query_fn, "with_inference"):
                    # capacity escalation cannot fix a groups_hint that
                    # undercounts the true distinct groups (a plan-author
                    # claim like Q13's, or hints analyzed against stand-in
                    # metadata) NOR a lying wire bound tripping the narrow-
                    # lane range check: after one failed escalation,
                    # recompile with no hints at all — the conservative
                    # program has no hint-induced overflow left (hash-
                    # dictionary group-bys degrade to the single-sort path)
                    # and, with no bounds, every exchange ships at full width
                    fn = query_fn.with_inference(False)
                continue
            if policy.deadline_s is not None and \
                    rep.wall_s > policy.deadline_s and \
                    attempt < policy.max_attempts:
                # straggler: correct but late — speculative re-execution
                rep.outcome = FailureKind.TRANSIENT.value
                rep.error = (f"deadline {policy.deadline_s:.3f}s exceeded "
                             f"({rep.wall_s:.3f}s)")
                continue
            return RunResult(result, stats, attempt, factor,
                             time.perf_counter() - t_start, report)
        raise RuntimeError(
            f"query overflowed at capacity_factor={factor:.1f} "
            f"after {policy.max_attempts} attempts")

    def _note_injected(self, report: RunReport) -> None:
        if self.chaos is not None:
            new = self.chaos.events[len(report.injected):]
            report.injected.extend(new)
            # attribute the injection's cut point to the current attempt row
            if new and report.attempts:
                report.attempts[-1].cut = new[-1].cut


def choose_exchange(cluster: pm.ClusterSpec, v: int, small_bytes: float,
                    large_bytes: float) -> str:
    """Cost-based broadcast-vs-shuffle decision (paper Eq. 3)."""
    return "broadcast" if pm.broadcast_beats_shuffle(
        cluster, v, small_bytes, large_bytes) else "shuffle"


def skew_imbalance(recv_counts: np.ndarray, k: int = 1) -> float:
    """Paper §3.5: max over nodes / mean (k devices per node).

    Validates the shape up front (a ragged ``len(recv_counts) % k`` used to
    surface as an opaque numpy reshape error) and returns the neutral 1.0
    for the empty / single-node edge instead of dividing by a clamped mean.
    """
    recv_counts = np.asarray(recv_counts)
    if k < 1:
        raise ValueError(f"devices-per-node k must be >= 1, got {k}")
    if recv_counts.size % k != 0:
        raise ValueError(
            f"recv_counts has {recv_counts.size} entries, not divisible by "
            f"k={k} devices per node")
    v = recv_counts.size // k
    if v <= 1:
        return 1.0   # nothing to be imbalanced against
    per_node = recv_counts.reshape(v, k).sum(axis=1)
    mean = per_node.mean()
    if mean == 0:
        return 1.0   # no traffic at all
    return float(per_node.max() / mean)


def salt_hot_keys(keys: np.ndarray, n_partitions: int,
                  hot_threshold: float = 4.0) -> np.ndarray:
    """Host-side salting: keys whose frequency exceeds ``hot_threshold`` x the
    mean get a per-row salt so their rows spread over all partitions.  Used
    before grouped shuffles (the merge aggregation is salt-agnostic since the
    final combine runs per full key)."""
    uniq, counts = np.unique(keys, return_counts=True)
    mean = counts.mean()
    hot = set(uniq[counts > hot_threshold * mean].tolist())
    if not hot:
        return keys
    salted = keys.astype(np.int64).copy()
    is_hot = np.isin(keys, list(hot))
    salt = np.arange(is_hot.sum(), dtype=np.int64) % n_partitions
    salted[is_hot] = salted[is_hot] * np.int64(n_partitions) + salt
    return salted
