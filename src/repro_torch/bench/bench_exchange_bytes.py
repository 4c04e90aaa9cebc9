"""Wire-byte bench: per-query exchange payload widths, from the logical-plan
IR alone (``planner.static_wire_stats``), no execution.

The paper's Hockney model (§3.6) makes interconnect bytes per row the
dominant distributed term; the narrow wire format (``core/wire.py``) ships
every exchanged column at its inferred lane width.  For each of the 22
plans this sums the per-row wire bytes of every exchange (shuffle,
broadcast, final gather) in the narrow format and in the wide one.

    PYTHONPATH=src python -m repro_torch.bench.bench_exchange_bytes [--check]

Writes ``--out`` (default ``results/torch/bench_exchange_bytes.json``).
``--check`` exits non-zero unless every query's narrow wire bytes are within
its absolute budget (``MAX_WIRE_BYTES``) and the shuffle-heavy queries drop
at least 40 % against wide (``MIN_WIRE_DROP_QUERIES``).
"""
from __future__ import annotations

from repro_torch.queries import QUERIES

from .common import Datasets, open_device, parser, write_report

# Absolute per-query budgets: summed narrow row-wire bytes across every
# exchange of the plan at sf 0.01, seed 7 (the bounds are column statistics
# of the generated database, stable per (sf, seed)); the reference's
# budgets, which the port's IR gives byte for byte.
MAX_WIRE_BYTES = {
    1: 92, 2: 28, 3: 16, 4: 12, 5: 20, 6: 0, 7: 20, 8: 32, 9: 44, 10: 32,
    11: 16, 12: 20, 13: 28, 14: 20, 15: 24, 16: 24, 17: 16, 18: 48, 19: 4,
    20: 16, 21: 16, 22: 32,
}

# Shuffle-heavy plans: narrow must cut >= 40 % of the wide format's bytes.
MIN_WIRE_DROP = 0.40
MIN_WIRE_DROP_QUERIES = (5, 7, 8, 9, 18)


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__, sf=0.01, seed=7, out="bench_exchange_bytes")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every query meets its absolute"
                         " wire-byte budget (and the shuffle-heavy set drops"
                         " >= 40%% against the wide format)")
    args = ap.parse_args(argv)
    open_device(args.device)          # the IR needs no device; it must exist
    db = (data or Datasets()).tpch(args.sf, args.seed)
    report = {"sf": args.sf, "seed": args.seed, "queries": {},
              "max_wire_bytes": MAX_WIRE_BYTES,
              "min_wire_drop": MIN_WIRE_DROP,
              "min_wire_drop_queries": list(MIN_WIRE_DROP_QUERIES)}
    ok = True
    for qid in sorted(QUERIES):
        narrow = QUERIES[qid].static_wire(db, narrow=True)
        wide = QUERIES[qid].static_wire(db, narrow=False)
        nb = sum(e["row_wire_bytes"] for e in narrow)
        wb = sum(e["row_wire_bytes"] for e in wide)
        lb = sum(e["row_logical_bytes"] for e in narrow)
        drop = 0.0 if wb == 0 else 1.0 - nb / wb
        budget = MAX_WIRE_BYTES[qid]
        q_ok = nb <= budget
        # the integer form of the >= 40 % rule (no float edge at 40 %)
        if qid in MIN_WIRE_DROP_QUERIES:
            q_ok &= (wb - nb) * 100 >= int(MIN_WIRE_DROP * 100) * wb
        report["queries"][f"q{qid}"] = {
            "wire_bytes_narrow": nb,
            "wire_bytes_wide": wb,
            "logical_bytes": lb,
            "max_wire_bytes": budget,
            "reduction": round(drop, 3),
            "exchanges": [
                {"kind": n["kind"], "narrow": n["row_wire_bytes"],
                 "wide": w["row_wire_bytes"],
                 "logical": n["row_logical_bytes"]}
                for n, w in zip(narrow, wide)],
        }
        ok &= q_ok
        flag = "" if q_ok else "  ** OVER BUDGET **"
        print(f"q{qid:2d}: wire {wb:3d} -> {nb:3d} bytes/row "
              f"({drop:.0%} drop, budget {budget}){flag}", flush=True)
    report["pass"] = bool(ok)
    write_report(args.out, report)
    if args.check and not ok:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
