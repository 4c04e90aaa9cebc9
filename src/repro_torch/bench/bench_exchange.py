"""Paper Figs. 6/7 (exchange microbenchmarks and model validation) and the
Hockney fits the projections use.

N = 8 ranks of a ``core.comm.ThreadGroup`` on one device shuffle and
broadcast a two-column table of 2^10 .. 2^18 rows per rank (16 bytes a
row).  The ranks' collectives are copies on that one device, so the fitted
constants describe on-device copies (``transport=threadgroup_one_card`` on
the card), not a network: the trend (latency floor, bandwidth saturation,
fit quality) is the deliverable, as in the reference, whose sweep ran on 8
virtual host devices.

    PYTHONPATH=src python -m repro_torch.bench.bench_exchange [--sizes 10 18]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core import perfmodel as pm
from repro_torch.core.exchange import broadcast_table, shuffle
from repro_torch.core.table import Table

from .common import Datasets, emit, open_device, parser, time_fn

N = 8


def make_table(rows: int, dev: torch.device, count: int | None = None
               ) -> Table:
    """Keys 0..rows-1 and ones, two 8-byte columns; ``count`` valid rows
    (default all)."""
    return Table({"k": torch.arange(rows, dtype=torch.int64, device=dev),
                  "v": torch.ones(rows, dtype=torch.float64, device=dev)},
                 torch.tensor(rows if count is None else count,
                              dtype=torch.int32, device=dev))


def transport(dev: torch.device) -> str:
    return "threadgroup_one_card" if dev.type == "cuda" else \
        "threadgroup_cpu"


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--sizes", type=int, nargs=2, default=(10, 18),
                    metavar=("LO", "HI"),
                    help="log2 rows per rank, from LO to HI inclusive")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    group = comm.ThreadGroup(N, dev)
    how = f"transport={transport(dev)};device={label}"
    meas = {"shuffle": [], "broadcast": []}
    for lg in range(args.sizes[0], args.sizes[1] + 1):
        rows = 1 << lg
        bytes_per_dev = rows * 16          # two 8-byte columns

        def do_shuffle(rows=rows):
            def body(g):
                t = make_table(rows, dev)
                return shuffle(t, t["k"], g, cap_per_dest=rows // N * 4)[0]
            return group.run(body)

        def do_broadcast(rows=rows):
            return group.run(lambda g: broadcast_table(make_table(rows, dev),
                                                       g)[0])

        t_sh = time_fn(do_shuffle, dev, iters=5)
        t_bc = time_fn(do_broadcast, dev, iters=5)
        total = bytes_per_dev * N
        meas["shuffle"].append((total / (N * N), t_sh))   # p2p message
        meas["broadcast"].append((bytes_per_dev, t_bc))   # ring payload
        emit(f"shuffle_{rows}rows", t_sh * 1e6,
             f"thpt_GBps={total / t_sh / 1e9:.3f};"
             f"msg_bytes={total // (N * N)};{how}")
        emit(f"broadcast_{rows}rows", t_bc * 1e6,
             f"thpt_GBps={total / t_bc / 1e9:.3f};"
             f"msg_bytes={bytes_per_dev};{how}")
    fits = {}
    for kind in ("shuffle", "broadcast"):
        ms = np.array([m for m, _ in meas[kind]], dtype=np.float64)
        ts = np.array([t for _, t in meas[kind]], dtype=np.float64)
        fit = fits[kind] = pm.fit_hockney(ms, ts)
        emit(f"hockney_{kind}", fit.latency * 1e6,
             f"inv_bw_s_per_byte={fit.inv_bw:.3e};"
             f"bw_at_1MB_GBps={fit.bandwidth(1e6) / 1e9:.3f};{how}")
        # model validation: predicted against measured at the largest size
        m_big, t_big = meas[kind][-1]
        pred = fit.time(m_big)
        emit(f"model_check_{kind}", pred * 1e6,
             f"measured_us={t_big * 1e6:.1f};"
             f"rel_err={abs(pred - t_big) / t_big:.3f};{how}")
    return {"device": label, "transport": transport(dev), "ranks": N,
            "measured": meas,
            "hockney": {k: {"latency_s": f.latency, "inv_bw": f.inv_bw}
                        for k, f in fits.items()}}


if __name__ == "__main__":
    main()
