"""§Roofline source: per-(arch x shape x mesh) terms from the LM dry-run's
records, as ``benchmarks/bench_roofline.py`` reduces the reference's.

Run ``python -m repro_torch.launch.dryrun --all`` first; this reads its
records (``results/torch/dryrun``, or ``--results``) and prints one CSV line
a cell, the reference's names and fields.  The terms are the dry-run's
arithmetic at ``h100_ib``'s published rates, not measurements, and no
device is used (``--device`` is taken for the runner's sake and unused).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .common import ROOT, emit

RESULTS = os.path.join(ROOT, "results", "torch", "dryrun")


def main(argv=None, data=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--device", default=None, help="unused")
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.results, "*.json")))
    if not files:
        emit("roofline_missing", 0, "run: python -m repro_torch.launch.dryrun "
             "--all")
        return []
    recs = []
    for f in files:
        with open(f) as fh:
            r = json.load(fh)
        recs.append(r)
        name = f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}"
        if r.get("skipped"):
            emit(name, 0, f"skipped:{r['skipped'][:40]}")
            continue
        if not r.get("ok"):
            emit(name, 0, f"FAILED:{r.get('error', '')[:60]}")
            continue
        rf = r["roofline"]
        emit(name, rf["step_lower_bound_s"] * 1e6,
             f"bottleneck={rf['bottleneck']};"
             f"compute_ms={rf['compute_s'] * 1e3:.2f};"
             f"memory_ms={rf['memory_s'] * 1e3:.2f};"
             f"collective_ms={rf['collective_s'] * 1e3:.2f};"
             f"roofline_frac={rf.get('roofline_frac', 0):.4f};"
             f"useful_flops={rf.get('useful_flop_frac', 0):.3f}")
    return recs


if __name__ == "__main__":
    main()
