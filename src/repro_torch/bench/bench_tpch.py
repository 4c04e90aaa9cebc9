"""Paper Fig. 10 (workload performance) and Table 4 (exchange counts).

Each query's time on one device through ``run_local`` (median of 3 after a
warm-up, the result read back to the host), the 22 queries' total, and each
plan's exchange counts beside the paper's Table 4.

    PYTHONPATH=src python -m repro_torch.bench.bench_tpch [--sf 1]
"""
from __future__ import annotations

from repro_torch.core import backend as B
from repro_torch.queries import PAPER_TABLE4, QUERIES

from .common import Datasets, emit, open_device, parser, time_fn


def main(argv=None, data: Datasets | None = None) -> dict:
    args = parser(__doc__, sf=0.01, seed=11).parse_args(argv)
    dev, label = open_device(args.device)
    db = (data or Datasets()).tpch(args.sf, args.seed)
    total, rows = 0.0, {}
    for qid in sorted(QUERIES):
        holder = {}

        def run(fn=QUERIES[qid]):
            out, holder["stats"] = B.run_local(fn, db, device=dev)
            return out

        t = time_fn(run, dev, warmup=1, iters=3)
        total += t
        s = holder["stats"]
        pc = PAPER_TABLE4.get(qid, (None, None))
        rows[qid] = {"s": t, "shuffles": s.shuffles,
                     "broadcasts": s.broadcasts,
                     "paper_shuffles": pc[0], "paper_broadcasts": pc[1]}
        emit(f"tpch_q{qid}", t * 1e6,
             f"sf={args.sf};shuffles={s.shuffles};broadcasts={s.broadcasts};"
             f"paper_shuffles={pc[0]};paper_broadcasts={pc[1]};"
             f"device={label}")
    emit("tpch_total_22q", total * 1e6,
         f"sf={args.sf};single_device;device={label}")
    return {"sf": args.sf, "seed": args.seed, "device": label,
            "queries": rows, "total_s": total}


if __name__ == "__main__":
    main()
