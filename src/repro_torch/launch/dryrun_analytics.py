"""Analytics dry-run: the 22 TPC-H plans at SF 1000 on 256 or 512 devices,
priced from the plan IR alone.

The counterpart of ``repro.launch.dryrun_analytics``, the paper's headline
artefact: 22 queries over ~6 B lineitem rows spread over a pod.  The
reference lowers each plan as a ``shard_map`` program over stand-in arrays
with SF 1000 row counts and reads FLOPs, traffic and collective bytes from
the compiled HLO.  PyTorch has no HLO, and the port's engine reads counts
to the host, so it cannot run a plan on stand-ins.  It does not need to:
every exchange size follows from the tables' capacities per device through
the engine's static capacity rules (``planner.static_exchange_stats``), so
the exchange log a ``DistContext`` of N ranks would write at SF 1000 is
derived here without running anything and without allocating on any
device.  The planner sees the SF 1000 key domains (:func:`sf_stats`);
dictionaries and other metadata come from a tiny generated database.

Per query it reports the exchange counts and log, the wire savings, the
exchange time the paper's model prices for that log
(``perfmodel.exchange_time_from_stats``: on ``tpu_v5e`` as the reference
prices it, one pod, and on the H100 clusters over N / 8 machines), and a
roofline whose memory term is the bytes of the columns the plan scans at
each table's capacity per device over the cluster's HBM bandwidth, and
whose collective term is the priced exchanges.  What only HLO could give
is ``null`` and named in ``not_reported``.  These are the model's
arithmetic, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_analytics \\
        [--queries 1,6,9|all] [--multi-pod]

Writes ``results/torch/analytics_dryrun/q{qid}_256.json`` (``_2x256`` with
``--multi-pod``).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.core import backend as B
from repro_torch.core import perfmodel as pm
from repro_torch.core import planner as PL
from repro_torch.data import tpch
from repro_torch.distributed.roofline import bound_terms
from repro_torch.queries import QUERIES

__all__ = ["SF1000_ROWS", "RESULTS", "scale_rows", "sf_stats", "table_caps",
           "scan_bytes", "metadata_db", "dryrun_query", "main"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "analytics_dryrun"

# SF 1000 row counts (paper §4.3 tables)
SF1000_ROWS = {
    "region": 5, "nation": 25, "supplier": 10_000_000,
    "customer": 150_000_000, "part": 200_000_000, "partsupp": 800_000_000,
    "orders": 1_500_000_000, "lineitem": 6_000_000_000,
}

# Key columns whose domain grows with the scale: at scale factor sf it is
# 1..rows of the owning table (the generator draws dense keys).  The tiny
# metadata database's bounds for these would let the planner infer hints
# valid only at its own scale, so they are overridden; dates, dictionary
# codes and quantities keep the tiny database's bounds, which do not
# depend on the scale.
_SCALE_KEYS = {
    "o_orderkey": "orders", "l_orderkey": "orders",
    "c_custkey": "customer", "o_custkey": "customer",
    "p_partkey": "part", "l_partkey": "part", "ps_partkey": "part",
    "s_suppkey": "supplier", "l_suppkey": "supplier",
    "ps_suppkey": "supplier",
}

# (cluster, machines for N devices): tpu_v5e as the reference prices it
# (one pod, v = 1); the H100 clusters over N / 8 machines of 8 cards
PRICED = ("tpu_v5e", "h100_ib", "h100_eth")

NOT_REPORTED = {
    "compute_s": "no HLO in the port: no FLOP count of the plan",
    "hlo_flops": "no HLO in the port",
    "hlo_bytes": "no HLO in the port: memory_s counts the scanned columns",
    "collective_bytes": "no HLO in the port: the exchange log, derived "
                        "from the IR, is priced instead",
}


def scale_rows(table: str, sf: float) -> int:
    """Rows of ``table`` at scale factor ``sf`` (dense keys 1..rows)."""
    return int(SF1000_ROWS[table] // 1000 * sf)


def sf_stats(db, sf: float) -> PL.stats_override:
    """A scoped override of ``db``'s column statistics with the key domains
    of scale factor ``sf`` (``planner.stats_override`` drops the planner's
    caches on entry and on exit, so ``db`` keeps none of them)."""
    stats = dict(PL.column_stats(db))
    for cname, table in _SCALE_KEYS.items():
        hi = scale_rows(table, sf)
        stats[cname] = PL.ColStats(1, hi, hi)
    return PL.stats_override(db, stats)


def table_caps(db, n: int) -> dict[str, int]:
    """Each table's capacity per device at SF 1000 over ``n`` devices: a
    partitioned table's share with 2 % headroom, a replicated one (no
    ``PARTITION_KEYS`` entry) whole, both in multiples of 8 rows."""
    caps = {}
    for name in db.tables:
        rows = SF1000_ROWS[name]
        if B.PARTITION_KEYS.get(name) is None:
            caps[name] = max(8, math.ceil(rows / 8) * 8)
        else:
            caps[name] = max(8, math.ceil(rows / n * 1.02 / 8) * 8)
    return caps


def scan_bytes(root, db, caps: dict[str, int]) -> int:
    """Bytes of the columns the plan's scans read, at each table's
    capacity per device (``planner.scan_columns``)."""
    return sum(caps[table] * db.tables[table][c].dtype.itemsize
               for table, cols in PL.scan_columns(root, db) for c in cols)


def metadata_db():
    """The tiny database whose dictionaries and scale-free statistics the
    dry-run plans against; its ``scale`` is SF 1000's (Q11's fraction)."""
    db = tpch.generate(0.001, seed=7)
    db.scale = 1000.0
    return db


def _machines(name: str, n: int) -> int:
    return 1 if name == "tpu_v5e" else max(1, n // pm.CLUSTERS[name].k)


def dryrun_query(qid: int, db, n: int, capacity_factor: float = 1.02,
                 packed: bool = True) -> dict:
    """Query ``qid`` at SF 1000 on ``n`` devices: its record (see the
    module docstring).  Host arithmetic over the IR only."""
    query = QUERIES[qid]
    caps = table_caps(db, n)
    t0 = time.perf_counter()
    with sf_stats(db, 1000.0):
        stats = PL.static_exchange_stats(
            query.plan, db, caps, n, capacity_factor=capacity_factor,
            packed=packed)
        read = scan_bytes(query.plan, db, caps)
    plan_s = time.perf_counter() - t0
    priced = {
        name: sum(pm.exchange_time_from_stats(
            e, pm.CLUSTERS[name], v=_machines(name, n), n_devices=n)
            for e in stats.log)
        for name in PRICED}
    return {
        "query": qid, "n_devices": n, "sf": 1000, "plan_s": plan_s,
        "plan": stats.counts(),
        "exchanges": [{"kind": e.kind, "message_bytes": e.message_bytes,
                       "total_bytes": e.total_bytes,
                       "collectives": e.collectives,
                       "row_wire_bytes": e.row_wire_bytes,
                       "row_logical_bytes": e.row_logical_bytes,
                       "wire": e.wire} for e in stats.log],
        "wire_savings": [round(pm.wire_savings(e), 3) for e in stats.log],
        "model_exchange_s": priced["tpu_v5e"],
        "model_exchange_s_by_cluster": priced,
        "machines": {name: _machines(name, n) for name in PRICED},
        "lineitem_rows_per_dev": caps["lineitem"],
        "scan_bytes_per_dev": read,
        "roofline": {name: bound_terms({
            "compute_s": None,
            "memory_s": read / pm.CLUSTERS[name].hbm_bw,
            "collective_s": priced[name]}) for name in PRICED},
        "hlo_flops": None, "hlo_bytes": None, "collective_bytes": None,
        "not_reported": NOT_REPORTED,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", default="1,4,6,9,13,18",
                    help="comma-separated query numbers, or all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2 x 256 devices on one flat exchange axis")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    qids = sorted(QUERIES) if args.queries == "all" else \
        [int(q) for q in args.queries.split(",")]
    n = 512 if args.multi_pod else 256
    sfx = "_2x256" if args.multi_pod else "_256"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    db = metadata_db()
    records = []
    for qid in qids:
        print(f"=== TPC-H Q{qid} @ SF=1000 on {n} devices", flush=True)
        try:
            rec = dryrun_query(qid, db, n)
            rf = rec["roofline"]
            print(f"  plan={rec['plan_s'] * 1e3:.1f}ms {rec['plan']} "
                  f"m={rf['h100_ib']['memory_s'] * 1e3:.1f}ms "
                  f"model_exchange tpu_v5e="
                  f"{rec['model_exchange_s'] * 1e3:.1f}ms h100_ib="
                  f"{rec['model_exchange_s_by_cluster']['h100_ib'] * 1e3:.1f}"
                  f"ms (model, not measured)", flush=True)
        except Exception as e:      # recorded per query, as the reference
            rec = {"query": qid, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-1500:]}
            print("  FAILED:", rec["error"][:200], flush=True)
        records.append(rec)
        with open(out / f"q{qid}{sfx}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return records


if __name__ == "__main__":
    main()
