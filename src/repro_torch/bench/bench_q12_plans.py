"""Paper Fig. 22 / §7.3: Q12 under different partitionings and plans, on
N = 8 ranks of a ``ThreadGroup`` on one device.

  default -- inputs co-partitioned on the join key: no exchange.
  Pa      -- inputs partitioned off-key: shuffle BOTH tables to the join key.
  Pb      -- inputs partitioned off-key: broadcast the filtered lineitem side.

Each plan's answer is held to the NumPy reference's at rtol 1e-7.

    PYTHONPATH=src python -m repro_torch.bench.bench_q12_plans [--sf 1]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import backend as B
from repro_torch.core import comm
from repro_torch.core.table import days
from repro_torch.queries import QUERIES

from .bench_exchange import N, transport
from .common import Datasets, emit, open_device, parser, time_fn

OFFKEY = {"lineitem": "l_partkey", "orders": "o_custkey"}


def _filtered_lineitem(ctx):
    l = ctx.scan("lineitem")                               # noqa: E741
    m = (ctx.isin(l, "l_shipmode", ["MAIL", "SHIP"]) &
         (l["l_commitdate"] < l["l_receiptdate"]) &
         (l["l_shipdate"] < l["l_commitdate"]) &
         (l["l_receiptdate"] >= days("1994-01-01")) &
         (l["l_receiptdate"] < days("1995-01-01")))
    return ctx.select(ctx.filter(l, m), "l_orderkey", "l_shipmode")


def _finish(ctx, j):
    hi = ["1-URGENT", "2-HIGH"]
    g = ctx.group_by(j, ["l_shipmode"], [
        ("high_line_count", "sum",
         lambda t: ctx.where(ctx.isin(t, "o_orderpriority", hi), 1, 0)),
        ("low_line_count", "sum",
         lambda t: ctx.where(ctx.isin(t, "o_orderpriority", hi), 0, 1)),
    ], exchange="gather", final=True)
    g = ctx.with_col(g, m_rank=lambda t: ctx.alpha_rank(t, "l_shipmode"))
    return ctx.finalize(g, sort_keys=[("m_rank", True)], replicated=True)


def q12_pa(ctx):
    """Shuffle both sides to the join key (plan Pa)."""
    ls = ctx.shuffle(_filtered_lineitem(ctx), "l_orderkey")
    o = ctx.scan("orders")
    os_ = ctx.shuffle(ctx.select(o, "o_orderkey", "o_orderpriority"),
                      "o_orderkey")
    j = ctx.join(ls, os_, "l_orderkey", "o_orderkey", ["o_orderpriority"])
    return _finish(ctx, j)


def q12_pb(ctx):
    """Broadcast the (small) filtered lineitem side (plan Pb)."""
    lb = ctx.broadcast(_filtered_lineitem(ctx))
    o = ctx.scan("orders")
    j = ctx.join(lb, o, "l_orderkey", "o_orderkey", ["o_orderpriority"])
    return _finish(ctx, j)


PLANS = (("default_copart", QUERIES[12], None),
         ("pa_shuffle_both", q12_pa, OFFKEY),
         ("pb_broadcast", q12_pb, OFFKEY))


def main(argv=None, data: Datasets | None = None) -> dict:
    args = parser(__doc__, sf=0.01, seed=11).parse_args(argv)
    dev, label = open_device(args.device)
    db = (data or Datasets()).tpch(args.sf, args.seed)
    group = comm.ThreadGroup(N, dev)
    ref, _ = B.run_reference(QUERIES[12], db)
    report = {"sf": args.sf, "seed": args.seed, "device": label,
              "plans": {}}
    for name, fn, pk in PLANS:
        def run(fn=fn, pk=pk, name=name):
            out, stats, ov = B.run_distributed(fn, db, group,
                                               capacity_factor=4.0,
                                               partition_keys=pk)
            if ov:
                raise RuntimeError(f"q12 {name}: capacity overflow")
            return out, stats
        out, stats = run()
        if set(out) != set(ref):
            raise AssertionError(f"q12 {name}: columns {sorted(out)}, the "
                                 f"reference's {sorted(ref)}")
        for k in ref:
            np.testing.assert_allclose(np.asarray(out[k], np.float64),
                                       np.asarray(ref[k], np.float64),
                                       rtol=1e-7, err_msg=f"{name} {k}")
        t = time_fn(lambda: run()[0], dev, warmup=1, iters=3)
        xbytes = sum(e.total_bytes for e in stats.log)
        emit(f"q12_{name}", t * 1e6,
             f"shuffles={stats.shuffles};broadcasts={stats.broadcasts};"
             f"exchange_bytes={xbytes};transport={transport(dev)};"
             f"device={label}")
        report["plans"][name] = {"s": t, "shuffles": stats.shuffles,
                                 "broadcasts": stats.broadcasts,
                                 "exchange_bytes": xbytes}
    return report


if __name__ == "__main__":
    main()
