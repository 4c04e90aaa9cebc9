"""Sample-ladder bench: per-rung warm wall against CI width for Q1, Q6 and
Q18.

For each query the exact plan and every rung of the ladder (1/16 .. 1/1)
are prepared once (the rung's sample built and uploaded, its PlanInfo
derived, both outside the clock, as ``QueryServer`` amortizes them); the
reported wall is the least of ``--reps`` runs of the prepared plan on
``--device``, ending in a device synchronise, beside the seconds its
preparation took (near 0 where an earlier caller in the process built the
rung's sample).  Each rung also reports the max relative CI half-width
``repro_torch.approx.estimators`` attaches to its answer: the two axes of
the trade ``ProgressiveRunner`` walks.  For each sampled rung it counts the
(group, aggregate) cells whose interval covers the exact plan's answer (up
to rtol 1e-7); a 95 % interval misses about 1 in 20, and a group's
aggregates share its sample, so misses come a group at a time and the share
is reported, not gated.  A cell off by more than 4 half-widths is a broken
estimate (a lost weight, a wrong stratum) and raises.

Q18 is refused on purpose: its grouped ``sum_qty`` feeds a HAVING-style
filter and two joins, so group membership would be decided by estimates
without bars; the rewrite refuses every sampled rung and only the
rename-only top rung runs.

    PYTHONPATH=src python -m repro_torch.bench.bench_approx [--check]

Writes ``--out`` (default ``results/torch/bench_approx.json``).  ``--check``
exits non-zero unless, for every query: the top rung (den 1) is
byte-identical to the exact plan; refusal is total (every sampled rung
refused, or none); the CI width never grows as the sample grows (the top
rung's is exactly 0); and, for measured ladders, the wall is monotone over
the sampled rungs (1/16 .. 1/2) within ``WALL_SLACK`` and the 1/16 rung is
at least ``SPEEDUP_MIN`` times faster than the exact plan.  The top rung is
left out of the wall gate: sampled rungs pay for the moment aggregates the
rename-only top rung drops.
"""
from __future__ import annotations

import math
import time

from repro_torch.approx.rewrite import rewrite_for_rung
from repro_torch.approx.sampling import LADDER
from repro_torch.core import backend as B
from repro_torch.core.table import to_numpy
from repro_torch.queries import QUERIES

from .common import Datasets, best_of, open_device, parser, write_report

QIDS = (1, 6, 18)
# the smallest rung must beat exact by at least this factor; adjacent rungs
# may regress by at most WALL_SLACK (timing noise on small inputs)
SPEEDUP_MIN = 1.25
WALL_SLACK = 1.15
CAPACITY_FACTOR = 3.0


def prepared(query, db, dev):
    """``query`` prepared against ``db`` on ``dev``: its tables resident
    and its PlanInfo derived by a first run (which must not overflow).
    Returns the run, a callable giving (result Table, overflow flag)."""
    tables = B.device_tables(db, dev)

    def run():
        ctx = B.LocalContext(db, tables, dev,
                             capacity_factor=CAPACITY_FACTOR)
        return B.result_table(query(ctx), dev), ctx.overflow

    if bool(run()[1]):
        raise RuntimeError(f"{getattr(query, 'name', query)}: capacity "
                           f"overflow")
    return run


def timed(run, dev, reps: int) -> tuple[float, dict]:
    """Least wall seconds of ``reps`` runs, and the last run's result."""
    held = {}
    wall = best_of(lambda: held.__setitem__("out", run()[0]), dev, reps)
    return wall, to_numpy(held["out"])


def coverage(est, targets, exact: dict) -> tuple[int, int]:
    """(covered, cells): the (group, aggregate) cells of ``est`` whose
    interval [estimate - half-width, estimate + half-width] holds the
    ``exact`` answer, up to rtol 1e-7; groups are matched on the columns
    that are not estimates.  Raises where a cell is off by more than 4
    half-widths."""
    names = [name for name, _ in targets]
    keys = [k for k in est.result if k not in names]
    rows = {tuple(exact[k][j].item() for k in keys): j
            for j in range(len(exact[names[0]]))}
    covered = cells = 0
    for i in range(len(est.result[names[0]])):
        j = rows[tuple(est.result[k][i].item() for k in keys)]
        for name in names:
            want = float(exact[name][j])
            err = abs(float(est.result[name][i]) - want)
            width, slack = float(est.half_width[name][i]), 1e-7 * abs(want)
            cells += 1
            covered += bool(err <= width + slack)
            if err > 4 * width + slack:
                raise AssertionError(f"{name}[{i}]: estimate off by {err} "
                                     f"against a half-width of {width}")
    return covered, cells


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__, sf=0.05, seed=7, out="bench_approx")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless identity + monotonicity gates "
                         "hold for every query")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    db = (data or Datasets()).tpch(args.sf, args.seed)
    queries, checks = {}, {}
    for qid in QIDS:
        q = QUERIES[qid]
        exact_wall, exact_cols = timed(prepared(q, db, dev), dev, args.reps)
        rungs, identical = [], True
        for den in LADDER:
            t0 = time.perf_counter()
            rw = rewrite_for_rung(q, db, den)
            if rw is None:
                if den == 1:
                    raise AssertionError(f"q{qid}: the rename-only top rung "
                                         f"refused")
                rungs.append({"den": den, "refused": True})
                continue
            run = prepared(rw.query, rw.db, dev)
            prep_s = time.perf_counter() - t0
            wall, cols = timed(run, dev, args.reps)
            est = rw.finalize(cols)
            ci = float(est.rel_width)
            rungs.append({"den": den, "prep_s": prep_s, "wall_s": wall,
                          "ci": None if math.isinf(ci) else ci})
            if den > 1:
                rungs[-1]["covered"], rungs[-1]["cells"] = coverage(
                    est, rw.targets, exact_cols)
            if den == 1:
                identical = set(cols) == set(exact_cols) and all(
                    cols[k].tobytes() == exact_cols[k].tobytes()
                    for k in exact_cols)
        measured = [r for r in rungs if not r.get("refused")]
        refused = len(rungs) - len(measured)
        walls = [r["wall_s"] for r in measured]
        cis = [math.inf if r["ci"] is None else r["ci"] for r in measured]
        c = checks[f"q{qid}"] = {
            "rung1_byte_identical": bool(identical),
            "refusal_is_total": refused in (0, len(LADDER) - 1),
            "ci_monotone_nonincreasing": all(
                a >= b - 1e-12 for a, b in zip(cis, cis[1:])),
            "top_rung_ci_zero": cis[-1] == 0.0,
        }
        if refused == 0:
            c["wall_monotone_with_slack"] = all(
                a <= b * WALL_SLACK for a, b in zip(walls[:-1], walls[1:-1]))
            c["smallest_rung_beats_exact"] = \
                walls[0] * SPEEDUP_MIN <= exact_wall
        else:
            # the estimability gate, not the latency ladder, is under test:
            # this shape folds grouped estimates into later computation
            c["sampled_rungs_refuse"] = refused == len(LADDER) - 1
        queries[f"q{qid}"] = {"exact_wall_s": exact_wall, "rungs": rungs}
        parts = []
        for r in rungs:
            if r.get("refused"):
                parts.append(f"1/{r['den']} refused")
                continue
            ci_s = "inf" if r["ci"] is None else f"{100 * r['ci']:.3f}%"
            cover = (f" covers {r['covered']}/{r['cells']}"
                     if "cells" in r else "")
            parts.append(f"1/{r['den']} {r['wall_s'] * 1e3:.3f}ms "
                         f"ci={ci_s}{cover} (prep {r['prep_s']:.2f}s)")
        print(f"q{qid}: exact {exact_wall * 1e3:.3f}ms | " + " ".join(parts)
              + f" (on {label})", flush=True)
    ok = all(all(c.values()) for c in checks.values())
    report = {"sf": args.sf, "seed": args.seed, "reps": args.reps,
              "device": label, "ladder": list(LADDER), "queries": queries,
              "checks": checks, "pass": bool(ok)}
    for qname, c in checks.items():
        for name, passed in c.items():
            if not passed:
                print(f"  FAIL {qname}.{name}")
    write_report(args.out, report)
    if args.check and not ok:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
