#!/usr/bin/env python3
"""Time the port's join index on one CUDA card: build, probe, and both.

    python3 tools/time_hash_join.py [--src DIR] [--reps N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  It goes through the join's public entry
points, ``core/relational.py::build_index`` and ``::probe_index``, whose
signatures every version keeps, at chip_smoke.py's shape: 15 M unique
order keys (a random permutation of 1..15 M) indexed at the default bucket
cap of 16, probed by 60 M keys drawn from 1..16.5 M (about 91 % hit).
:func:`time_index` times the hash index and, beside it, the sorted index
over the same keys; ``chip_smoke.py`` calls it for its phase-3 line.
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

M, N, SEED = 15_000_000, 60_000_000, 11


def time_index(build, probe, reps: int = 5, bucket_cap: int = 16) -> dict:
    """Build, probe and build-and-probe ms of the ``hash`` and the
    ``sorted`` index of the (m,) int64 ``build`` keys (unique, on a CUDA
    card), probed by ``probe``, through the ``repro_torch`` on the path.
    Each is the mean of ``reps`` calls after a warm-up (CUDA events).  Both
    indexes must match the same probes, each to a row holding its key."""
    import torch
    from repro_torch.core import relational as rel
    from repro_torch.core.table import Table

    dev = build.device
    table = Table({"k": build}, torch.tensor(build.shape[0],
                                             dtype=torch.int32, device=dev))
    valid = torch.ones(probe.shape[0], dtype=torch.bool, device=dev)

    def mean_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    out, hits = {}, []
    for method in ("hash", "sorted"):
        index = rel.build_index(table, build, method, bucket_cap=bucket_cap)
        if method == "hash" and bool(index.overflow):
            raise AssertionError("the hash index overflowed")
        matched, rows = rel.probe_index(index, probe, valid)
        if not torch.equal(build[rows[matched]], probe[matched]):
            raise AssertionError(f"the {method} index matched wrong rows")
        hits.append(matched)
        out[method] = {
            "build_ms": mean_ms(lambda: rel.build_index(
                table, build, method, bucket_cap=bucket_cap)),
            "probe_ms": mean_ms(lambda: rel.probe_index(index, probe, valid)),
            "build_and_probe_ms": mean_ms(lambda: rel.probe_index(
                rel.build_index(table, build, method, bucket_cap=bucket_cap),
                probe, valid)),
        }
        del index, matched, rows
    if not torch.equal(*hits):
        raise AssertionError("the hash and sorted indexes matched other "
                             "probes")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_hash_join: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(SEED)
    build = torch.randperm(M, generator=g, device=dev) + 1
    probe = torch.randint(1, M + M // 10, (N,), generator=g, device=dev)
    out = time_index(build, probe, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "build_keys": M,
                      "probes": N, "reps": args.reps, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
