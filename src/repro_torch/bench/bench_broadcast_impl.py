"""Paper Fig. 19 / §7.1: collective broadcast against p2p-emulated
broadcast.

The p2p ring forwards the whole shard N-1 times (duplicated traffic); the
collective ``all_gather`` moves it once.  Wall times (N = 8 ranks of a
``ThreadGroup`` on one device) beside the ``ExchangeStats`` byte counts the
performance model uses.

    PYTHONPATH=src python -m repro_torch.bench.bench_broadcast_impl
"""
from __future__ import annotations

from repro_torch.core import comm
from repro_torch.core.exchange import broadcast_table, broadcast_table_p2p

from .bench_exchange import N, make_table, transport
from .common import Datasets, emit, open_device, parser, time_fn


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--sizes", type=int, nargs="+", default=(12, 15, 18),
                    help="log2 rows per rank")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    group = comm.ThreadGroup(N, dev)
    how = f"transport={transport(dev)};device={label}"
    report = {"device": label, "ranks": N, "sizes": {}}
    for lg in args.sizes:
        rows = 1 << lg
        stats = {}

        def run(p2p: bool, rows=rows, stats=stats):
            def body(g):
                t = make_table(rows, dev)
                if p2p:
                    out, st = broadcast_table_p2p(t, g)
                else:
                    out, _, _, st = broadcast_table(t, g)
                stats[p2p] = st
                return out
            return group.run(body)

        t_coll = time_fn(lambda: run(False), dev, iters=5)
        t_p2p = time_fn(lambda: run(True), dev, iters=5)
        st_c, st_p = stats[False], stats[True]
        emit(f"broadcast_collective_{rows}rows", t_coll * 1e6,
             f"collectives={st_c.collectives};bytes={st_c.total_bytes};"
             f"{how}")
        emit(f"broadcast_p2p_{rows}rows", t_p2p * 1e6,
             f"collectives={st_p.collectives};bytes={st_p.total_bytes};"
             f"slowdown={t_p2p / t_coll:.2f}x;{how}")
        report["sizes"][rows] = {
            "collective_s": t_coll, "p2p_s": t_p2p,
            "collective_bytes": st_c.total_bytes,
            "p2p_bytes": st_p.total_bytes,
            "collective_collectives": st_c.collectives,
            "p2p_collectives": st_p.collectives}
    return report


if __name__ == "__main__":
    main()
