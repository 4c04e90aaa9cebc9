"""Paper Figs. 8/9 (exchange under skew), 20/21 (JCC-H partitions and
per-query).

A shuffle and a broadcast with a skew gradient f (the paper's synthetic
placement: rank i holds x + i*f*x rows) on N = 8 ranks of a ``ThreadGroup``
on one device; the partition imbalance of JCC-H's skewed lineitem against
TPC-H's when partitioned by ``l_partkey`` (``backend.partition_database``,
a host function); and Q4 and Q13 through ``run_distributed`` on both
databases.

    PYTHONPATH=src python -m repro_torch.bench.bench_skew [--sf 1]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core.exchange import broadcast_table, shuffle
from repro_torch.core.table import Database
from repro_torch.queries import QUERIES

from .bench_exchange import N, make_table, transport
from .common import Datasets, emit, open_device, parser, time_fn

BASE_ROWS = 1 << 14
SKEW_FACTORS = (0.0, 0.5, 1.0, 2.0)
JCCH_SKEW = 0.3


def skewed_counts(f: float) -> np.ndarray:
    """Rank i holds x*(1+i*f) rows, the total fixed at N*BASE_ROWS."""
    w = 1 + np.arange(N) * f
    return np.maximum(8, (BASE_ROWS * N * w / w.sum()).astype(np.int64))


def lineitem_imbalance(db) -> tuple[np.ndarray, int]:
    """lineitem's rows per rank and per-rank capacity when partitioned by
    ``l_partkey`` over N ranks (only lineitem is partitioned: the other
    tables do not change its numbers)."""
    li = Database({"lineitem": db.tables["lineitem"]}, db.dicts, db.scale)
    parts, caps = B.partition_database(
        li, N, partition_keys={"lineitem": "l_partkey"})
    return parts["lineitem"]["__count"], caps["lineitem"]


def main(argv=None, data: Datasets | None = None) -> dict:
    args = parser(__doc__, sf=0.005, seed=11).parse_args(argv)
    dev, label = open_device(args.device)
    data = data or Datasets()
    group = comm.ThreadGroup(N, dev)
    how = f"transport={transport(dev)};device={label}"
    cap = BASE_ROWS * 4
    report = {"device": label, "ranks": N, "gradient": {}, "jcch": {},
              "queries": {}}
    for f in SKEW_FACTORS:
        counts = skewed_counts(f)

        def do_shuffle(counts=counts):
            def body(g):
                t = make_table(cap, dev, int(counts[g.rank]))
                return shuffle(t, t["k"], g, cap_per_dest=cap)[0]
            return group.run(body)

        def do_broadcast(counts=counts):
            return group.run(lambda g: broadcast_table(
                make_table(cap, dev, int(counts[g.rank])), g)[0])

        t_sh = time_fn(do_shuffle, dev, iters=3)
        t_bc = time_fn(do_broadcast, dev, iters=3)
        imb = counts.max() / counts.mean()
        emit(f"skew_shuffle_f{f}", t_sh * 1e6, f"imbalance={imb:.2f};{how}")
        emit(f"skew_broadcast_f{f}", t_bc * 1e6,
             f"imbalance={imb:.2f};{how}")
        report["gradient"][f] = {"shuffle_s": t_sh, "broadcast_s": t_bc,
                                 "imbalance": float(imb)}
    # JCC-H against TPC-H: partition imbalance (the paper's Fig. 20 proxy:
    # peak memory tracks partition size under static-capacity tables)
    dbs = (("tpch", data.tpch(args.sf, args.seed)),
           ("jcch", data.jcch(args.sf, args.seed, JCCH_SKEW)))
    for name, db in dbs:
        c, lcap = lineitem_imbalance(db)
        emit(f"{name}_lineitem_imbalance",
             float(c.max()) / float(c.mean()) * 100,
             f"max={int(c.max())};mean={c.mean():.0f};cap={lcap}")
        report["jcch"][name] = {"counts": c.tolist(), "cap": lcap}
    # per query (Fig. 21): Q4 and Q13 under uniform and skewed data
    for qid in (4, 13):
        for name, db in dbs:
            def run(qid=qid, db=db):
                out, _, ov = B.run_distributed(QUERIES[qid], db, group,
                                               capacity_factor=4.0)
                if ov:
                    raise RuntimeError(f"q{qid} {name}: capacity overflow")
                return out
            t = time_fn(run, dev, warmup=1, iters=2)
            emit(f"q{qid}_{name}_dist8", t * 1e6, how)
            report["queries"][f"q{qid}_{name}"] = t
    return report


if __name__ == "__main__":
    main()
