"""End-to-end distributed analytics driver on the PyTorch port (the
paper's Figure 1b workflow).

Runs the full 22-query TPC-H workload over 8 ranks (a ``ThreadGroup`` on
one device) with the fault-tolerant runner: host-partitioned load (§4.3),
capacity-bounded collective exchanges, re-execution on overflow, per-query
exchange stats.

    PYTHONPATH=src python examples/torch_analytics_distributed.py \
        [--sf 0.01] [--queries 3,9] [--device cpu]

Under ``torchrun`` (``WORLD_SIZE`` set) every process is one rank on its
own card, ``cuda:LOCAL_RANK``, over NCCL, or on the CPU over gloo with
``--device cpu``; ``--ranks`` is then the world's size, and rank 0 prints:

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        examples/torch_analytics_distributed.py --sf 1

Runs on ``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import os
import argparse

from repro_torch.core import comm
from repro_torch.core.table import resolve_device
from repro_torch.data import tpch
from repro_torch.distributed.fault import QueryRunner
from repro_torch.queries import QUERIES


def main(argv=None, db=None) -> dict:
    """Prints the reference's line per query; returns, per query, its
    result, wall ms, rows, exchange counts and attempts.  ``db`` replaces
    the generated database."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--queries", type=str, default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:          # torchrun: a rank per process
        group = comm.world_group(args.device)
    else:
        group = comm.ThreadGroup(args.ranks, resolve_device(args.device))
    try:
        return _run(args, db, group)
    finally:
        if isinstance(group, comm.TorchDistGroup):
            group.close()


def _run(args, db, group) -> dict:
    say = print if 0 in group.ranks else (lambda *a, **k: None)
    if db is None:
        db = tpch.generate(args.sf, seed=args.seed)
    say(f"devices={group.size}  scale factor={db.scale} on {group.device}")
    runner = QueryRunner(db, group=group, capacity_factor=2.5)

    qids = ([int(q) for q in args.queries.split(",") if q]
            or sorted(QUERIES))
    total, out = 0.0, {}
    for qid in qids:
        res = runner.run(QUERIES[qid])
        total += res.wall_s
        nrows = len(next(iter(res.result.values()))) if res.result else 0
        out[qid] = {"result": res.result, "ms": res.wall_s * 1e3,
                    "rows": nrows, "shuffles": res.stats.shuffles,
                    "broadcasts": res.stats.broadcasts,
                    "attempts": res.attempts}
        say(f"Q{qid:2d}  {res.wall_s * 1e3:9.1f} ms  rows={nrows:5d}  "
            f"shuffles={res.stats.shuffles} "
            f"broadcasts={res.stats.broadcasts} "
            f"attempts={res.attempts}")
    say(f"\nall {len(qids)} queries: {total:.2f} s "
        f"(includes the first partition and upload)")
    return out


if __name__ == "__main__":
    main()
