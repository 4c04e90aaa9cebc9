"""Paper §6.7: the engine against a single-node CPU baseline.

The paper compares against DuckDB; here the baseline is the port's NumPy
reference executor (``backend.run_reference``: an independent
implementation over exact-size host arrays).  Both run the same 22 logical
plans: the engine on ``--device`` (the card unless asked for the CPU), the
baseline on the host's CPU.

    PYTHONPATH=src python -m repro_torch.bench.bench_baseline [--sf 0.1]
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as B
from repro_torch.queries import QUERIES

from .common import Datasets, emit, open_device, parser, time_fn


def main(argv=None, data: Datasets | None = None) -> dict:
    args = parser(__doc__, sf=0.01, seed=11).parse_args(argv)
    dev, label = open_device(args.device)
    host = torch.device("cpu")
    db = (data or Datasets()).tpch(args.sf, args.seed)
    t_engine = t_base = 0.0
    for qid in sorted(QUERIES):
        fn = QUERIES[qid]
        t_engine += time_fn(lambda: B.run_local(fn, db, device=dev)[0], dev,
                            warmup=1, iters=3)
        t_base += time_fn(lambda: B.run_reference(fn, db)[0], host,
                          warmup=0, iters=3)
    emit("baseline_numpy_22q", t_base * 1e6,
         f"sf={args.sf};ran_on=host_cpu_numpy")
    emit("engine_torch_22q", t_engine * 1e6,
         f"sf={args.sf};ran_on={label};note=engine on the device against "
         f"the NumPy reference on the host CPU (median of 3 per query, "
         f"summed)")
    return {"sf": args.sf, "seed": args.seed, "device": label,
            "engine_s": t_engine, "baseline_numpy_s": t_base,
            "speedup": t_base / t_engine}


if __name__ == "__main__":
    main()
