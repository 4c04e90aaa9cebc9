"""Quickstart on the PyTorch port: generate TPC-H, run queries on the
tensor engine, read results.

    PYTHONPATH=src python examples/torch_quickstart.py [--sf 0.01] \
        [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import argparse

import numpy as np

from repro_torch.core import backend as B
from repro_torch.core.table import resolve_device
from repro_torch.data import tpch
from repro_torch.queries import QUERIES


def main(argv=None, db=None) -> dict:
    """Prints what the reference's quickstart prints; returns the row
    counts, Q1's, Q6's and Q19's results and exchange counts, and Q1's
    decoded return flags.  ``db`` replaces the generated database."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if db is None:
        print(f"Generating TPC-H SF={args.sf} ...")
        db = tpch.generate(args.sf, seed=args.seed)
    rows = {name: len(next(iter(t.values()))) for name, t in db.tables.items()}
    for name, n in rows.items():
        print(f"  {name:10s} {n:>8,d} rows")

    results, counts = {}, {}
    for qid in (1, 6, 19):
        result, stats = B.run_local(QUERIES[qid], db, device=dev)
        results[qid], counts[qid] = result, stats.counts()
        print(f"\nQ{qid}  (shuffles={stats.shuffles} "
              f"broadcasts={stats.broadcasts})")
        cols = list(result)[:6]
        print("  " + " | ".join(f"{c:>16s}" for c in cols))
        n = len(next(iter(result.values())))
        for i in range(min(n, 5)):
            row = []
            for c in cols:
                v = result[c][i]
                row.append(f"{v:16.2f}" if isinstance(v, (float, np.floating))
                           else f"{v!s:>16s}")
            print("  " + " | ".join(row))

    # decode a dictionary-encoded column back to strings
    flags = [str(f) for f in db.dicts["l_returnflag"][
        results[1]["l_returnflag"].astype(int)]]
    print("\nQ1 return flags decoded:", flags)
    return {"rows": rows, "results": results, "counts": counts,
            "q1_flags": flags}


if __name__ == "__main__":
    main()
