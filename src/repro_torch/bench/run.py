"""Run the port's benches in the reference's order, in one process.

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu] [--check]
        [names...]

Prints the ``name,us_per_call,derived`` CSV (and the gated benches' report
lines), each bench under a ``# <name>`` line and followed by its seconds.
The multi-rank benches run their 8 ranks as a ``ThreadGroup`` on the one
device: no subprocess.  ``--check`` asks the gated benches for their gates.
``bench_roofline`` reduces the LM dry-run's records
(``python -m repro_torch.launch.dryrun``) and uses no device.
"""
from __future__ import annotations

import argparse
import importlib
import time
from pathlib import Path

from .common import Datasets

# the reference's run.py order, then its gated benches
ORDER = ("bench_tpch", "bench_baseline", "bench_projection", "bench_kernels",
         "bench_exchange", "bench_skew", "bench_broadcast_impl",
         "bench_q12_plans", "bench_exchange_bytes", "bench_sort_tax",
         "bench_recovery", "bench_serve", "bench_approx")
# benches that read records and use no device: run after ORDER's
HOST_ONLY = ("bench_roofline",)
# the benches that write a JSON report (``--out``) and take ``--check``
GATED = ("bench_exchange_bytes", "bench_sort_tax", "bench_recovery",
         "bench_serve", "bench_approx")
# each bench at its smallest useful size: a run that shows every bench
# builds, launches and passes its gates, in seconds
SMALLEST = {
    "bench_tpch": ["--sf", "0.005"],
    "bench_baseline": ["--sf", "0.005"],
    "bench_kernels": ["--rows", "65536"],
    "bench_exchange": ["--sizes", "10", "11"],
    "bench_skew": ["--sf", "0.005"],
    "bench_broadcast_impl": ["--sizes", "10"],
    "bench_q12_plans": ["--sf", "0.005"],
    "bench_sort_tax": ["--sf", "0.005", "--seed", "11"],
    "bench_recovery": ["--sf", "0.01", "--reps", "1"],
    "bench_serve": ["--sf", "0.01", "--reps", "1"],
    "bench_approx": ["--sf", "0.01", "--reps", "3"],
}


def run(names, device: str, args: dict | None = None,
        out_dir: str | None = None, check: bool = False,
        data: Datasets | None = None) -> dict[str, float]:
    """Run the benches ``names`` on ``device``, each with its ``args`` and,
    for the gated ones, ``--out <out_dir>/<name>.json`` (where ``out_dir``
    is given) and ``--check`` (where ``check``).  The benches share
    ``data``'s generated databases.  A failed gate or any error propagates.
    Returns each bench's seconds."""
    data = data or Datasets()
    secs = {}
    for name in names:
        mod = importlib.import_module(f"{__package__}.{name}")
        argv = ["--device", device, *(args or {}).get(name, [])]
        if name in GATED:
            if out_dir is not None:
                argv += ["--out", str(Path(out_dir) / f"{name}.json")]
            if check:
                argv.append("--check")
        print(f"# {name} {' '.join(argv)}", flush=True)
        t0 = time.perf_counter()
        mod.main(argv, data)
        secs[name] = time.perf_counter() - t0
        print(f"# {name}: {secs[name]:.1f} s", flush=True)
    return secs


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="run the gated benches with their gates")
    ap.add_argument("names", nargs="*",
                    help="benches to run (default: all, in order)")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(ORDER + HOST_ONLY)
    if unknown:
        ap.error(f"unknown benches: {sorted(unknown)}")
    print("name,us_per_call,derived", flush=True)
    names = [n for n in ORDER + HOST_ONLY
             if not args.names or n in args.names]
    return run(names, args.device, check=args.check)


if __name__ == "__main__":
    main()
