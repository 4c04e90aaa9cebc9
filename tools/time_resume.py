#!/usr/bin/env python3
"""Time a lineage resume against a full run on one CUDA card, and the part
of the resume that restores snapshots.

    python3 tools/time_resume.py [--src DIR] [--sf SF] [--queries Q ...]
        [--reps N] [--profile]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  Per query (default Q18) at ``--sf``
(default 10, seed 11), with ``bench_recovery``'s capacity factor 3: a store
populated as ``bench_recovery`` populates it (a run whose fault fires at
``finalize``), then a warm-up and ``--reps`` samples each of ``run_local``
(the full run) and ``run_resumable`` (the resume), every sample ended by a
synchronise and printed, with the seconds the resume spent in
``LineageStore.load`` (reading, checking and uploading its snapshots).
With ``--profile``, the resume's host calls by their own time over
``--reps`` resumes (``cProfile``), the twelve largest.  Snapshots go under
``build/`` and are removed.  Prints one JSON line with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 11
CAPACITY_FACTOR = 3.0


def time_resume(dev, sf: float, queries, reps: int, profile: bool) -> dict:
    import torch
    from repro_torch.core import backend as B
    from repro_torch.data import tpch
    from repro_torch.distributed.chaos import (ChaosInjector, FaultPlan,
                                               FaultSpec, TransientFault)
    from repro_torch.distributed.lineage import LineageStore, run_resumable
    from repro_torch.queries import QUERIES

    class TimedLoads(LineageStore):
        load_s = 0.0

        def load(self, tag, ctx):
            t = time.perf_counter()
            out = super().load(tag, ctx)
            torch.cuda.synchronize(dev)
            self.load_s += time.perf_counter() - t
            return out

    def walls(fn) -> list[float]:
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t)
        return out

    db = tpch.generate(sf, seed=SEED)
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="time_resume_", dir=ROOT / "build")
    report = {}
    try:
        for qid in queries:
            q = QUERIES[qid]
            store = TimedLoads(f"{work}/q{qid}")
            try:
                run_resumable(q, db, store, capacity_factor=CAPACITY_FACTOR,
                              chaos=ChaosInjector(FaultPlan(qid, (FaultSpec(
                                  "transient", cut="finalize",
                                  attempt=1),))), device=dev)
            except TransientFault:
                pass
            full = walls(lambda: B.run_local(
                q, db, capacity_factor=CAPACITY_FACTOR, device=dev))
            loads = []

            def resume():
                store.load_s = 0.0
                run_resumable(q, db, store, capacity_factor=CAPACITY_FACTOR,
                              device=dev)
                loads.append(store.load_s)
            resumed = walls(resume)
            entry = {"full_s": full, "resume_s": resumed,
                     "load_s": loads[1:],          # the warm-up's dropped
                     "min_ratio": min(resumed) / min(full)}
            if profile:
                prof = cProfile.Profile()
                prof.enable()
                for _ in range(reps):
                    resume()
                torch.cuda.synchronize(dev)
                prof.disable()
                text = io.StringIO()
                pstats.Stats(prof, stream=text).sort_stats(
                    "tottime").print_stats(12)
                entry["host_by_own_time"] = [
                    line.strip() for line in text.getvalue().splitlines()
                    if line.strip() and line.strip()[0].isdigit()]
            report[f"q{qid}"] = entry
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--queries", type=int, nargs="+", default=[18])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--profile", action="store_true",
                    help="also list the resume's host calls by own time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_resume: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    out = time_resume(torch.device("cuda:0"), args.sf, args.queries,
                      args.reps, args.profile)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "sf": args.sf,
                      "reps": args.reps, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
