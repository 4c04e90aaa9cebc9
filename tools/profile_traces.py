#!/usr/bin/env python3
"""Count ``torch.profiler`` traces that hold no device event, on one CUDA
card, for short runs of the port taken one after another.

    python3 tools/profile_traces.py [--src DIR] [--sf SF] [--rounds N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``).  At
``--sf`` (default 1, seed 11): every TPC-H query once, Q1, Q6, Q9 and Q18
each in a trace of its own, Q6 through ``run_distributed`` on 4 ranks; then,
``--rounds`` times for Q1 and Q6, a trace of the 1/2 rung and one of the
exact plan, back to back (the sequence in which ``chip_smoke.py``'s phase
7c once got empty traces).  Each trace is taken once, with no retry: its
device events, their summed ms, the CPU events and the kernels linked to
them are printed, and the traces without a device event are counted.  Run
it with ``TEARDOWN_CUPTI=0`` in the environment to keep CUPTI subscribed
between traces.  Prints one JSON line with the card's name and power limit
last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 11


def trace(fn) -> dict:
    """One trace of ``fn``: its device and CPU events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    window = time.perf_counter() - t
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    cpu = [e for e in prof.events() if e.device_type != DeviceType.CUDA]
    return {"device_events": len(device),
            "device_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
            "cpu_events": len(cpu),
            "kernels_linked": sum(len(e.kernels) for e in cpu),
            "window_ms": window * 1e3}


def count_traces(dev, sf: float, rounds: int) -> dict:
    from repro_torch.approx.rewrite import rewrite_for_rung
    from repro_torch.core import backend as B
    from repro_torch.data import tpch
    from repro_torch.queries import QUERIES
    db = tpch.generate(sf, seed=SEED)
    for q in sorted(QUERIES):
        B.run_local(QUERIES[q], db, device=dev)
    traces = []

    def take(label, fn):
        traces.append({"run": label, **trace(fn)})
        print(json.dumps(traces[-1]), flush=True)

    for q in (1, 6, 9, 18):
        take(f"q{q}", lambda: B.run_local(QUERIES[q], db, device=dev))
    take("q6 on 4 ranks", lambda: B.run_distributed(QUERIES[6], db, 4,
                                                    device=dev))
    for q in (1, 6):
        half = rewrite_for_rung(QUERIES[q], db, 2)
        for r in range(rounds):
            take(f"q{q} rung 1/2, round {r}",
                 lambda: B.run_local(half.query, half.db, device=dev))
            take(f"q{q} exact, round {r}",
                 lambda: B.run_local(QUERIES[q], db, device=dev))
    return {"traces": len(traces),
            "empty": sum(t["device_events"] == 0 for t in traces),
            "teardown_cupti": os.environ.get("TEARDOWN_CUPTI")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_traces: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    out = count_traces(torch.device("cuda:0"), args.sf, args.rounds)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "sf": args.sf, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
