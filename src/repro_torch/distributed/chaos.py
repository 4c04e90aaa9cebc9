"""Seeded, deterministic fault injection — the chaos harness.

The paper's fault story (§2.4) is "re-execute the whole query"; proving that
story (and the finer-grained recovery this repo layers on top) requires
*injecting* every failure domain on demand, deterministically, so a CI leg
can replay the exact same fault schedule on every commit.

A :class:`FaultPlan` is a seeded list of :class:`FaultSpec` entries, each
naming WHERE (a cut point: ``scan`` / ``exchange`` / ``group_by`` /
``finalize``, or ``any`` for the first cut visited), WHEN (which visit of
that cut, on which run attempt) and WHAT (a fault kind) to inject.  The
:class:`ChaosInjector` holds the plan plus per-attempt visit counters; the
execution backends call :meth:`ChaosInjector.fire` from
``_BaseContext._chaos_point`` at every cut point.

Fault kinds and their mechanism:

  ``transient``      raises :class:`TransientFault` (simulated node loss /
                     flaky link) — aborts the attempt.
  ``deterministic``  raises ``ValueError`` (simulated plan-author bug) —
                     the fault runner must surface it on attempt 1, never
                     burn retries on it.
  ``straggler``      sleeps ``delay_s`` (simulated slow node) — the attempt
                     succeeds, late; visible in per-attempt wall time.
  ``overflow``       ORs the ``ctx.overflow`` flag (simulated lying
                     capacity bound) — exercises the escalation ladder.
  ``corrupt``        returns a payload-tamper callable that flips one
                     seed-chosen bit of the received exchange buffer before
                     its checksum is verified — the checksum must catch it.
                     At cut points with no checksummed payload in flight the
                     detection is simulated by ORing ``ctx.corrupt``.
  ``device_lost``    raises :class:`DeviceLost` naming one or more mesh
                     participants dead — either an explicit ``devices`` set
                     or ``n_lost`` seeded-random ranks.  The fault runner
                     answers with a topology shrink: a new mesh over the
                     survivors, re-plan, re-execute.

Enabled for any test or bench via the ``REPRO_CHAOS`` env leg: unset / ``0``
/ ``off`` disables; any other integer seeds :meth:`FaultPlan.default` (one
transient + one corrupt + one overflow across the first three attempts) and
arms the fault runner's default injector (``ChaosInjector.from_env``).  A
``lose=`` suffix (``REPRO_CHAOS="<seed>,lose=<r0>[+<r1>...][@<cut>]"``)
arms :meth:`FaultPlan.device_loss` instead: the named ranks die at the
named cut (default ``exchange``) on attempt 1.

Everything here is deterministic in (seed, plan, query): the same schedule
fires at the same cut visits and flips the same bit on every run — chaos
you can bisect.

Ranks.  The reference package traces one SPMD program, so each cut is
visited once per attempt.  Here every rank of a rank group
(:mod:`repro_torch.core.comm`) runs the plan itself and reaches every cut.
The injector therefore counts visits per rank (``ctx.group.rank``; 0 off a
group), fires a due spec on every rank at the same visit — as the one
traced program fires it on every device — and records each
:class:`FiredFault` once.  The counters are taken under a lock: the ranks of
a ``ThreadGroup`` are threads.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
import threading
import zlib

import torch

__all__ = [
    "FailureKind", "TransientFault", "DeviceLost", "FaultSpec", "FaultPlan",
    "FiredFault", "ChaosInjector", "chaos_env_seed", "chaos_env_lost",
    "resolve_lost", "CUT_POINTS", "FAULT_KINDS",
]

CUT_POINTS = ("scan", "exchange", "group_by", "finalize")
FAULT_KINDS = ("transient", "deterministic", "straggler", "overflow",
               "corrupt", "device_lost")


class FailureKind(enum.Enum):
    """Failure taxonomy consumed by the retry policy (distributed/fault.py).

    TRANSIENT      environment fault (node loss, flaky link, timeout):
                   retry with exponential backoff.
    OVERFLOW       capacity/bound violation (the overflow-not-wrong flag):
                   escalate the capacity factor, then drop planner hints.
    CORRUPT        payload failed its wire integrity checksum: re-run on the
                   conservative wide format — never serve the bad buffer.
    DETERMINISTIC  a plan-author bug (TypeError, ValueError, assertion …):
                   raise immediately; retrying cannot help.
    DEVICE_LOST    one or more mesh participants are gone for good: retrying
                   on the same topology can only fail again — shrink the
                   mesh to the survivors, re-plan at the new width, and
                   re-execute (the topology-elastic rung).
    TOLERANCE_MISS an approximate answer's confidence interval exceeded the
                   caller's tolerance (approximate answers): not an
                   execution failure — the attempt ran clean — but the
                   outcome climbs the sample ladder to the next larger rung
                   the way OVERFLOW climbs the capacity factor.
    """
    TRANSIENT = "transient"
    OVERFLOW = "overflow"
    CORRUPT = "corrupt"
    DETERMINISTIC = "deterministic"
    DEVICE_LOST = "device_lost"
    TOLERANCE_MISS = "tolerance_miss"


class TransientFault(RuntimeError):
    """Simulated (or real) environment fault: node loss, dropped link.
    Classified TRANSIENT by the fault runner — retried with backoff."""


class DeviceLost(RuntimeError):
    """One or more mesh participants are permanently dead.

    ``lost`` is the tuple of dead device ranks when the injection site knew
    the live mesh width (``ctx.N`` on the distributed context, the logical
    ``lineage_devices`` width on resumable eager runs); otherwise it is
    empty and ``n_lost`` tells the fault runner how many seeded-random
    ranks to resolve against its own mesh (:func:`resolve_lost`).
    Classified DEVICE_LOST — recovered by topology shrink, never by
    same-topology retry."""

    def __init__(self, message: str, lost: tuple[int, ...] = (),
                 n_lost: int = 1, seed: int = 0):
        super().__init__(message)
        self.lost = tuple(lost)
        self.n_lost = int(n_lost)
        self.seed = int(seed)


def resolve_lost(exc: "DeviceLost", world: int) -> tuple[int, ...]:
    """Dead ranks of a :class:`DeviceLost` against a ``world``-wide mesh.

    Explicit ranks are clipped to the mesh; an unresolved fault picks
    ``n_lost`` distinct seeded-random ranks.  Never returns the whole mesh:
    at least one survivor remains (a query with zero devices is not a
    topology, it is an outage)."""
    if exc.lost:
        lost = tuple(sorted({d for d in exc.lost if 0 <= d < world}))
    else:
        ranks = list(range(world))
        lost_l: list[int] = []
        for i in range(min(exc.n_lost, world)):
            j = _mix(exc.seed, "device_lost", i) % len(ranks)
            lost_l.append(ranks.pop(j))
        lost = tuple(sorted(lost_l))
    if len(lost) >= world:
        lost = lost[: world - 1]
    return lost


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: WHAT (``kind``), WHERE (``cut``, ``index``) and
    WHEN (``attempt``, 1-based).  ``devices`` / ``n_lost`` parameterize a
    ``device_lost`` fault: an explicit dead-rank set, or how many
    seeded-random ranks to kill when the set is empty."""
    kind: str                 # one of FAULT_KINDS
    cut: str = "any"          # CUT_POINTS entry, or "any" = first cut visited
    index: int = 0            # which visit of that cut within the attempt
    attempt: int = 1          # fires on this run attempt only
    delay_s: float = 0.05     # straggler sleep
    devices: tuple[int, ...] = ()   # device_lost: explicit dead ranks
    n_lost: int = 1           # device_lost: seeded-random kill count

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.cut != "any" and self.cut not in CUT_POINTS:
            raise ValueError(f"unknown cut point {self.cut!r}")
        object.__setattr__(self, "devices", tuple(self.devices))
        if any(int(d) < 0 for d in self.devices):
            raise ValueError(f"negative device rank in {self.devices!r}")
        if self.kind == "device_lost" and not self.devices \
                and self.n_lost < 1:
            raise ValueError("device_lost needs devices or n_lost >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of faults.  The seed drives every data-dependent
    choice (which bit a corrupt fault flips), so a plan replays exactly."""
    seed: int
    faults: tuple[FaultSpec, ...]

    @classmethod
    def default(cls, seed: int) -> "FaultPlan":
        """The chaos-sweep schedule: one transient, one corrupt and one
        overflow fault across the first three attempts — a clean run needs
        attempt 4, exercising every recovery path of the retry policy.
        ``group_by`` covers scalar-only plans too (``agg_scalar`` fires it)."""
        return cls(seed, (
            FaultSpec("transient", cut="scan", index=0, attempt=1),
            FaultSpec("corrupt", cut="group_by", index=0, attempt=2),
            FaultSpec("overflow", cut="any", index=0, attempt=3),
        ))

    @classmethod
    def device_loss(cls, seed: int, devices: tuple[int, ...] = (),
                    n_lost: int = 1, cut: str = "exchange") -> "FaultPlan":
        """The topology-shrink schedule: the named ranks (or ``n_lost``
        seeded-random ones) die at the first visit of ``cut`` on attempt 1;
        the clean re-execution on the shrunken mesh is attempt 2."""
        return cls(seed, (
            FaultSpec("device_lost", cut=cut, index=0, attempt=1,
                      devices=tuple(devices), n_lost=n_lost),
        ))


@dataclasses.dataclass(frozen=True)
class FiredFault:
    """One injection that actually happened — surfaced in the RunReport."""
    attempt: int
    cut: str
    index: int
    kind: str
    simulated: bool = False   # corrupt w/o a checksummed payload in flight


def _mix(seed: int, *parts) -> int:
    """Deterministic (process-stable) integer from seed + context parts —
    NOT python ``hash()``, which is salted per process."""
    return zlib.crc32(repr((seed,) + parts).encode())


def chaos_env_seed() -> int | None:
    """``REPRO_CHAOS`` env leg: unset / ``0`` / ``off`` -> None (disabled);
    any other value is the integer seed of the armed fault plan.  A
    ``,lose=...`` suffix (see :func:`chaos_env_lost`) does not change the
    seed parse."""
    v = os.environ.get("REPRO_CHAOS", "").strip().lower()
    v = v.split(",", 1)[0].strip()
    if v in ("", "0", "off", "false", "none"):
        return None
    return int(v)


def chaos_env_lost() -> tuple[tuple[int, ...], str] | None:
    """Device-loss suffix of ``REPRO_CHAOS``: ``<seed>,lose=<r0>[+<r1>...]
    [@<cut>]`` -> (dead ranks, cut point); None when absent.

    ``REPRO_CHAOS="1,lose=3"`` kills rank 3 at the first exchange;
    ``REPRO_CHAOS="1,lose=1+4+6@scan"`` kills ranks 1, 4 and 6 at the first
    scan.  With the suffix present the armed plan is
    :meth:`FaultPlan.device_loss` instead of :meth:`FaultPlan.default`."""
    v = os.environ.get("REPRO_CHAOS", "").strip().lower()
    if "," not in v:
        return None
    suffix = v.split(",", 1)[1].strip()
    if not suffix.startswith("lose="):
        raise ValueError(f"REPRO_CHAOS suffix {suffix!r}: expected lose=...")
    spec = suffix[len("lose="):]
    cut = "exchange"
    if "@" in spec:
        spec, cut = spec.split("@", 1)
    ranks = tuple(int(r) for r in spec.split("+") if r)
    if not ranks:
        raise ValueError("REPRO_CHAOS lose= names no ranks")
    return ranks, cut


class ChaosInjector:
    """Stateful driver of a :class:`FaultPlan` across run attempts.

    The fault runner calls :meth:`begin_attempt` before each (re-)execution;
    the backends call :meth:`fire` at every cut point, once per rank.  Fired
    faults are recorded in :attr:`events` for the per-attempt RunReport, one
    entry per (attempt, cut, visit) however many ranks fire it.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.events: list[FiredFault] = []
        self._lock = threading.Lock()
        self.begin_attempt(1)

    @classmethod
    def from_env(cls) -> "ChaosInjector | None":
        seed = chaos_env_seed()
        if seed is None:
            return None
        lost = chaos_env_lost()
        if lost is not None:
            ranks, cut = lost
            return cls(FaultPlan.device_loss(seed, devices=ranks, cut=cut))
        return cls(FaultPlan.default(seed))

    def begin_attempt(self, attempt: int) -> None:
        """Reset the visit counters for a fresh (re-)execution."""
        with self._lock:
            self._attempt = attempt
            # rank -> (visits per cut, visits of any cut)
            self._visits: dict[int, tuple[dict[str, int], list[int]]] = {}
            self._fired: set[tuple[int, str, int]] = set()

    # -- injection ----------------------------------------------------------
    def fire(self, cut: str, ctx, tamperable: bool = False):
        """Called by ``_BaseContext._chaos_point``.  Returns a tamper
        callable for a corrupt fault the call site can route into a
        checksummed exchange, else None.  May raise, sleep, or OR fault
        flags on ``ctx`` — see the module docstring."""
        rank = getattr(getattr(ctx, "group", None), "rank", 0)
        with self._lock:
            per_cut, total = self._visits.setdefault(rank, ({}, [0]))
            i = per_cut.get(cut, 0)
            per_cut[cut] = i + 1
            spec = self._due(cut, i, total[0])
            total[0] += 1
            if spec is not None:
                simulated = spec.kind == "corrupt" and not tamperable
                self._record(cut, i, spec.kind, simulated)
        if spec is None:
            return None
        if spec.kind == "transient":
            raise TransientFault(
                f"chaos: node lost at {cut}#{i} (attempt {self._attempt})")
        if spec.kind == "deterministic":
            raise ValueError(
                f"chaos: plan bug at {cut}#{i} (attempt {self._attempt})")
        if spec.kind == "straggler":
            time.sleep(spec.delay_s)
            return None
        if spec.kind == "device_lost":
            world = getattr(ctx, "N", None) or \
                getattr(ctx, "lineage_devices", None)
            lost = spec.devices
            if not lost and world:
                lost = resolve_lost(DeviceLost("", n_lost=spec.n_lost,
                                               seed=self.plan.seed),
                                    int(world))
            # raised without a name in this frame: the traceback holds the
            # frame, which must not hold the error (a cycle keeps the
            # rank's tables alive until a garbage collection)
            raise DeviceLost(
                f"chaos: device(s) lost at {cut}#{i} "
                f"(attempt {self._attempt})", lost=lost,
                n_lost=spec.n_lost, seed=self.plan.seed)
        if spec.kind == "overflow":
            ctx.overflow = ctx.overflow | True
            return None
        # corrupt: flip a seed-chosen payload bit where a checksummed buffer
        # is in flight; otherwise simulate the detection
        if not tamperable:
            ctx.corrupt = ctx.corrupt | True
            return None
        return self._tamper(cut, i)

    def _record(self, cut: str, index: int, kind: str,
                simulated: bool) -> None:
        """One :class:`FiredFault` per (attempt, cut, visit), whichever rank
        gets there first (called under the lock)."""
        key = (self._attempt, cut, index)
        if key not in self._fired:
            self._fired.add(key)
            self.events.append(FiredFault(self._attempt, cut, index, kind,
                                          simulated=simulated))

    def _due(self, cut: str, index: int, total: int) -> FaultSpec | None:
        for spec in self.plan.faults:
            if spec.attempt != self._attempt:
                continue
            if spec.cut == "any":
                if total == spec.index:
                    return spec
            elif spec.cut == cut and spec.index == index:
                return spec
        return None

    def _tamper(self, cut: str, index: int):
        """Payload corrupter: flips ONE bit, chosen deterministically from
        (seed, cut, index, attempt) — the reference's word and bit.  The
        32-bit words are flipped through an int32 view (torch's CPU has no
        ``>>`` or ``%`` for uint32), bit 31 as the int32 mask -2**31."""
        r = _mix(self.plan.seed, cut, index, self._attempt)
        bit = (r >> 16) & 31
        mask = -(1 << 31) if bit == 31 else 1 << bit

        def tamper(payload: torch.Tensor) -> torch.Tensor:
            flat = payload.reshape(-1).view(torch.int32).clone()
            pos = r % max(1, flat.shape[0])
            flat[pos] ^= mask
            return flat.view(payload.dtype).reshape(payload.shape)

        return tamper
