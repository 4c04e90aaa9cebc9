"""Paper Figs. 13/14 and Fig. 16: workload projection across cluster sizes
and price-performance, from the §3 analytical models (Projection I and the
'+Small Msg' Projection II with Hockney fits).  Arithmetic only
(``core/perfmodel.py``): its lines equal the reference's.

    PYTHONPATH=src python -m repro_torch.bench.bench_projection
"""
from __future__ import annotations

from repro_torch.core import perfmodel as pm
from repro_torch.core.table import resolve_device

from .common import Datasets, emit, parser

# representative per-exchange workset bytes for the 22-query workload at
# SF=1000 (paper §6.5: 80th-pct messages imply worksets of O(1-10 GiB))
EXCHANGES = [("shuffle", 2e9)] * 10 + [("broadcast", 1e9)] * 14
COMPUTE_V1 = 1.06        # paper: 22 queries, 1 VM (8 GPUs), seconds


def main(argv=None, data: Datasets | None = None) -> None:
    args = parser(__doc__).parse_args(argv)
    resolve_device(args.device)       # no device work; the device must exist
    fits = {
        # Hockney constants of IB-class networks (order-of-magnitude, §3.6)
        "bn": pm.Hockney(latency=20e-6, inv_bw=1 / 45e9),
        "bg": pm.Hockney(latency=5e-6, inv_bw=1 / 400e9),
    }
    for cname in ("h100_ib", "a100_eth", "tpu_v5e"):
        spec = pm.CLUSTERS[cname]
        # Projection I (peak-bandwidth)
        p1 = pm.project_workload(spec, range(1, 9), COMPUTE_V1, EXCHANGES)
        # Projection II (+ small messages): NIC Hockney constants only make
        # sense for the paper's GPU clusters; the TPU pod row keeps proj I.
        p2 = None
        if cname != "tpu_v5e":
            p2 = pm.project_workload(spec, range(1, 9), COMPUTE_V1, EXCHANGES,
                                     hockney_n=fits["bn"],
                                     hockney_g=fits["bg"])
        for v in (1, 2, 4, 8):
            emit(f"project_{cname}_v{v}", p1[v]["total"] * 1e6,
                 f"projI;compute={p1[v]['compute']:.3f};"
                 f"shuffle={p1[v]['shuffle']:.4f};"
                 f"broadcast={p1[v]['broadcast']:.4f}")
            if p2:
                emit(f"project_smallmsg_{cname}_v{v}", p2[v]["total"] * 1e6,
                     f"projII;broadcast={p2[v]['broadcast']:.4f}")
        # the paper's observation: adding machines stops helping at some V
        best_v = min(range(1, 9), key=lambda v: (p2 or p1)[v]["total"])
        emit(f"project_best_v_{cname}", best_v,
             "argmin total (paper: no gain beyond V~6)")
    # price-performance (Fig 16): QPS/$ for 22 queries
    for cname in ("a100_eth", "h100_ib", "mi300x_ib"):
        spec = pm.CLUSTERS[cname]
        if not spec.price_hr:
            continue
        p = pm.project_workload(spec, [1], COMPUTE_V1, EXCHANGES)
        qps = 22.0 / p[1]["total"]
        emit(f"qps_per_usd_{cname}_v1", qps / spec.price_hr * 3600 * 1e-3,
             f"qps={qps:.1f};price_hr={spec.price_hr}")


if __name__ == "__main__":
    main()
