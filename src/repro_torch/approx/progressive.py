"""Progressive execution: climb the sample ladder until the CI fits.

The protocol mirrors the fault runner's escalation policies — in fact it
*reuses* them: every rung executes through a :class:`QueryRunner`, so
transient faults back off, overflow climbs ``capacity_factor``, corruption
falls back to the wide wire format, all inside one rung.  What is new is the
outcome BETWEEN rungs: an attempt that ran clean but whose reported
confidence interval exceeds the caller's tolerance is stamped
``FailureKind.TOLERANCE_MISS`` and the runner climbs to the next larger rung,
the way OVERFLOW climbs the capacity factor.

Termination is structural, not statistical: the ladder is finite and its top
rung (``den == 1``) is the full table — the rewrite there is a pure scan
rename with zero-width intervals, so the loop can always end with an exact
answer.  Plans the rewrite pass refuses (min/max, semi/anti-dependent counts,
tiny domains, multi-scan aggregates) skip the ladder entirely and run exact
(``rung == 0``).

``REPRO_APPROX`` (env) sets the default serving tolerance: unset / ``0`` /
``off`` means exact-only; any float (e.g. ``0.05``) makes
``QueryServer.submit`` answer approximately within that relative CI
half-width unless the caller passes an explicit ``tolerance=``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core import comm
from repro_torch.core.table import resolve_device
from repro_torch.distributed.chaos import FailureKind
from repro_torch.distributed.fault import QueryRunner, RunReport

from . import rewrite as R
from . import sampling

__all__ = ["approx_default", "ApproxAnswer", "ProgressiveRunner"]


def approx_default() -> float | None:
    """The ``REPRO_APPROX`` default tolerance (None = exact-only serving)."""
    raw = os.environ.get("REPRO_APPROX", "").strip().lower()
    if raw in ("", "0", "off", "none", "false"):
        return None
    return float(raw)


@dataclasses.dataclass
class ApproxAnswer:
    """Result of a progressive run, with its provenance."""

    result: dict          # numpy columns (moment columns stripped)
    rung: int             # ladder denominator answered from; 0 = exact plan
    ci_width: float       # max relative CI half-width (0.0 when exact)
    confidence: float
    tolerance: float
    exact: bool           # rung in (0, 1): no sampling error at all
    escalations: int      # tolerance misses climbed past
    report: RunReport     # merged per-rung attempt audit (rung + ci tagged)


class ProgressiveRunner:
    """Answer from the smallest rung; escalate while CI > tolerance.

    ``group=None`` (the default) runs each rung on the single-device engine
    on ``device`` (``cuda`` unless the caller names another; raises where
    CUDA is absent).  ``group`` is otherwise what ``QueryRunner`` takes: a
    rank group (:mod:`repro_torch.core.comm`) or a rank count N, which means
    one ``ThreadGroup`` of N ranks on ``device`` for every rung.  Then rungs
    execute distributed — the sample tables partition on the base table's
    key, and the CLT moments ride the partial-aggregate merges, so the
    error bars are exchange-invariant.
    """

    def __init__(self, db, group=None, tolerance: float = 0.05,
                 confidence: float = 0.95, ladder=sampling.LADDER,
                 seed: int = sampling.DEFAULT_SEED,
                 min_rows: int = R.MIN_SAMPLE_ROWS, tables=None,
                 capacity_factor: float = 2.0, max_attempts: int = 4,
                 join_method: str = "sorted", wire_format: str | None = None,
                 policy=None, chaos=None,
                 device: str | torch.device | None = None):
        if tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        self.db = db
        if isinstance(group, int):
            group = comm.ThreadGroup(group, device)
        self.group = group
        self.device = group.device if group is not None \
            else resolve_device(device)
        self.tolerance = float(tolerance)
        self.confidence = float(confidence)
        # largest denominator (smallest sample) first; top rung must be 1 so
        # the ladder always ends exact
        self.ladder = tuple(sorted(set(int(d) for d in ladder), reverse=True))
        if not self.ladder or self.ladder[-1] != 1:
            raise ValueError(f"ladder must end at rung 1, got {ladder}")
        bad = [d for d in self.ladder if d not in sampling.LADDER]
        if bad:
            # fail here, not mid-run(): rewrite_for_rung rejects off-ladder
            # denominators, so a bad custom ladder must never start climbing
            raise ValueError(f"ladder rungs {bad} are not on the sampling "
                             f"ladder {sampling.LADDER}")
        self.seed = seed
        self.min_rows = min_rows
        self.tables = tables
        self._runner_kwargs = dict(
            capacity_factor=capacity_factor, max_attempts=max_attempts,
            join_method=join_method, wire_format=wire_format, policy=policy,
            chaos=chaos)

    def _run_rung(self, db, query_fn):
        runner = QueryRunner(db, self.group, device=self.device,
                             **self._runner_kwargs)
        return runner.run(query_fn)

    def run(self, query) -> ApproxAnswer:
        """Execute one compiled query progressively.

        ``query`` must be a ``planner.CompiledQuery`` (bind serve templates
        first, or go through ``QueryServer.submit(tolerance=...)``).
        """
        report = RunReport()
        escalations = 0
        for den in self.ladder:
            rw = R.rewrite_for_rung(query, self.db, den, seed=self.seed,
                                    min_rows=self.min_rows,
                                    tables=self.tables)
            if rw is None:
                break    # non-estimable shape: the honest answer is exact
            rr = self._run_rung(rw.db, rw.query)
            est = rw.finalize(rr.result, self.confidence)
            for a in rr.report.attempts:
                a.rung = den
            rr.report.attempts[-1].ci_width = est.rel_width
            report.attempts.extend(rr.report.attempts)
            report.injected.extend(rr.report.injected)
            if est.rel_width <= self.tolerance or den == 1:
                return ApproxAnswer(
                    result=est.result, rung=den, ci_width=est.rel_width,
                    confidence=self.confidence, tolerance=self.tolerance,
                    exact=(den == 1), escalations=escalations, report=report)
            # clean execution, interval too wide: climb the ladder the way
            # OVERFLOW climbs capacity_factor
            rr.report.attempts[-1].outcome = FailureKind.TOLERANCE_MISS.value
            escalations += 1
        rr = self._run_rung(self.db, query)
        rr.report.attempts[-1].ci_width = 0.0
        report.attempts.extend(rr.report.attempts)
        report.injected.extend(rr.report.injected)
        return ApproxAnswer(
            result=rr.result, rung=0, ci_width=0.0,
            confidence=self.confidence, tolerance=self.tolerance,
            exact=True, escalations=escalations, report=report)
