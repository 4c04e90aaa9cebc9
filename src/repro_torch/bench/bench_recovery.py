"""Recovery bench: lineage resume against whole-query re-execution.

The paper's fault story is re-execution from durable inputs (§2.4): a
failed query costs a full second pass.  The lineage store
(``repro_torch.distributed.lineage``) snapshots every post-exchange table
through the CRC-checked checkpoint writer, so a query that dies after its
exchanges resumes from the topmost durable exchange and re-executes only
the plan's suffix.  Per query, on ``--device``:

  * ``full_s``    -- warm re-execution of the whole query (``run_local``,
                     no lineage armed);
  * ``resume_s``  -- warm resume from a populated store: restore the
                     topmost snapshot (CRC-verified) and run the suffix;
  * ``reshard_s`` -- warm resume at a narrower logical width (snapshots
                     written for 8 devices, resumed at 5): the
                     degraded-topology path, which adopts the width-mismatched
                     snapshots through the store's re-shard rule.

Times are the least of ``--reps`` after a warm-up.  The store is populated
once by a run whose fault fires at ``finalize``: the snapshots a failed
attempt would leave behind; their count, bytes and write seconds are
reported.  Every resume must reuse a snapshot and return the full run's
result byte for byte, and a same-width resume must not re-shard.
Snapshots go under ``--work`` (default: a temporary directory beside
``--out``), each query's removed once it is measured.

    PYTHONPATH=src python -m repro_torch.bench.bench_recovery [--check]

Writes ``--out`` (default ``results/torch/bench_recovery.json``).
``--check`` exits non-zero unless every gated query resumes in less than
``MAX_RECOVERY_RATIO`` of its full re-execution and re-shards in less than
``MAX_RESHARD_RATIO``.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path

from repro_torch.core import backend as B
from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                           FaultSpec, TransientFault)
from repro_torch.distributed.lineage import LineageStore, run_resumable
from repro_torch.queries import QUERIES

from .common import Datasets, best_of, open_device, parser, write_report

# Resume must cost less than this fraction of a full re-execution: the gated
# queries have deep exchange trees (joins feeding a group-by), so the suffix
# after the topmost exchange is a small tail of the plan.
MAX_RECOVERY_RATIO = 0.6
# A resume at another width pays the same restore and suffix (snapshots are
# stored in global row order), with a budget of its own so that a fault in
# the re-shard rule shows by itself.
MAX_RESHARD_RATIO = 0.7
RESHARD_FROM, RESHARD_TO = 8, 5
# the queries the ratio gates apply to; every query asked for is measured
RECOVERY_QUERIES = (5, 9, 18)
CAPACITY_FACTOR = 3.0


class TimedStore(LineageStore):
    """A store that adds up the seconds its snapshot writes take (the copy
    to the host, the npy write and its CRC)."""
    write_s = 0.0

    def save(self, tag, table, ctx, node=None):
        t = time.perf_counter()
        super().save(tag, table, ctx, node)
        self.write_s += time.perf_counter() - t


def _bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _same_bytes(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and got[k].tobytes() ==
        want[k].tobytes() for k in want)


def _populate(q, qid: int, db, store, dev, n_devices: int) -> None:
    """The snapshots a mid-query failure leaves: the fault fires at
    finalize, after every exchange is durable."""
    inj = ChaosInjector(FaultPlan(qid, (
        FaultSpec("transient", cut="finalize", attempt=1),)))
    try:
        run_resumable(q, db, store, capacity_factor=CAPACITY_FACTOR,
                      chaos=inj, n_devices=n_devices, device=dev)
    except TransientFault:
        return
    raise AssertionError(f"q{qid}: the finalize fault did not fire")


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__, sf=0.05, seed=7, out="bench_recovery")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--queries", type=int, nargs="*", default=None,
                    help="query ids to measure (default: the gated set)")
    ap.add_argument("--work", default=None,
                    help="directory for the snapshots (default: beside "
                         "--out)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every gated query resumes in"
                         " < MAX_RECOVERY_RATIO x full re-execution")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    qids = args.queries if args.queries else sorted(RECOVERY_QUERIES)
    db = (data or Datasets()).tpch(args.sf, args.seed)
    report = {"sf": args.sf, "seed": args.seed, "reps": args.reps,
              "device": label,
              "max_recovery_ratio": MAX_RECOVERY_RATIO,
              "max_reshard_ratio": MAX_RESHARD_RATIO,
              "reshard_widths": [RESHARD_FROM, RESHARD_TO],
              "gated_queries": sorted(RECOVERY_QUERIES), "queries": {}}
    ok = True
    parent = Path(args.work or Path(args.out).parent)
    parent.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_recovery_", dir=parent)
    try:
        for qid in qids:
            q = QUERIES[qid]
            store = TimedStore(f"{work}/q{qid}")
            _populate(q, qid, db, store, dev, 1)
            snapshots = store.saved       # before resumes reset the count
            if snapshots < 1:
                raise AssertionError(f"q{qid}: no exchange snapshot written")
            nbytes = _bytes(store.dir)
            full, _ = B.run_local(q, db, capacity_factor=CAPACITY_FACTOR,
                                  device=dev)
            full_s = best_of(lambda: B.run_local(
                q, db, capacity_factor=CAPACITY_FACTOR, device=dev), dev,
                args.reps, warmup=1)

            def resume(st, width):
                got, _, overflow, reused = run_resumable(
                    q, db, st, capacity_factor=CAPACITY_FACTOR,
                    n_devices=width, device=dev)
                if overflow or reused < 1 or not _same_bytes(got, full):
                    raise AssertionError(
                        f"q{qid}: the resume at width {width} reused "
                        f"{reused} snapshots, overflow {overflow}, or its "
                        f"result differs from the full run's")
            resume_s = best_of(lambda: resume(store, 1), dev, args.reps,
                               warmup=1)
            if store.resharded:
                raise AssertionError(f"q{qid}: a same-width resume "
                                     f"re-sharded")
            # snapshots written for 8 devices, adopted by a resume at 5
            wide = LineageStore(f"{work}/q{qid}_w")
            _populate(q, qid, db, wide, dev, RESHARD_FROM)
            reshard_s = best_of(lambda: resume(wide, RESHARD_TO), dev,
                                args.reps, warmup=1)
            if wide.resharded < 1:
                raise AssertionError(f"q{qid}: the resume did not take the "
                                     f"re-shard path")
            store.clear()
            wide.clear()
            ratio, reshard_ratio = resume_s / full_s, reshard_s / full_s
            gated = qid in RECOVERY_QUERIES
            q_ok = (not gated) or (ratio < MAX_RECOVERY_RATIO
                                   and reshard_ratio < MAX_RESHARD_RATIO)
            ok &= q_ok
            report["queries"][f"q{qid}"] = {
                "full_s": full_s, "resume_s": resume_s,
                "ratio": round(ratio, 3), "reshard_s": reshard_s,
                "reshard_ratio": round(reshard_ratio, 3),
                "snapshots": snapshots, "snapshot_bytes": nbytes,
                "snapshot_write_s": store.write_s, "gated": gated}
            flag = "" if q_ok else "  ** OVER RATIO **"
            print(f"q{qid:2d}: full {full_s * 1e3:7.2f}ms -> resume "
                  f"{resume_s * 1e3:7.2f}ms  (ratio {ratio:.3f}) -> reshard "
                  f"{RESHARD_FROM}->{RESHARD_TO} {reshard_s * 1e3:7.2f}ms "
                  f"(ratio {reshard_ratio:.3f}); {snapshots} snapshots, "
                  f"{nbytes / 1e9:.3f} GB written in {store.write_s:.2f} s; "
                  f"each resume byte-identical to the full run, on "
                  f"{label}{flag}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["pass"] = bool(ok)
    write_report(args.out, report)
    if args.check and not ok:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
