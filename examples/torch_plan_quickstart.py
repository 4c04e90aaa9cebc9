"""Builder-API quickstart on the PyTorch port: TPC-H Q6 as a lazy logical
plan, end to end.

Builds a plan DAG with the fluent builder, inspects what the planner infers
(key widths, group bounds, derived exchange counts, placement validation),
then runs the SAME plan object on the NumPy reference backend and the
PyTorch local backend.

    PYTHONPATH=src python examples/torch_plan_quickstart.py [--sf 0.01] \
        [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import argparse

import numpy as np

from repro_torch.core import backend as B
from repro_torch.core.plan import col, result, scan
from repro_torch.core.planner import compile_query
from repro_torch.core.table import days, resolve_device
from repro_torch.data import tpch
from repro_torch.queries import QUERIES


def q6_plan():
    """TPC-H Q6: revenue change from hypothetical discount elimination.

    A pure scan-filter-aggregate — one allreduce, zero other exchanges."""
    l = scan("lineitem").filter(
        (col("l_shipdate") >= days("1994-01-01")) &
        (col("l_shipdate") < days("1995-01-01")) &
        (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07) &
        (col("l_quantity") < 24))
    s = l.agg_scalar([("revenue", "sum",
                       col("l_extendedprice") * col("l_discount"))])
    return result(revenue=s["revenue"])


def main(argv=None, db=None) -> dict:
    """Prints what the reference's plan quickstart prints; returns the
    static counts, notes and explanations, both revenues, and Q1's result
    and decoded flags.  ``db`` replaces the generated database."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if db is None:
        db = tpch.generate(args.sf, seed=args.seed)
    q6 = compile_query(q6_plan, name="q6")

    # the plan is data: inspect it before running anything
    out = {"static_counts": q6.static_counts(), "notes": q6.validate(db),
           "explain_q6": q6.explain(db)}
    print("static exchange counts (no execution):", out["static_counts"])
    print("placement validation notes:", out["notes"] or "clean")
    print(out["explain_q6"])

    # one plan object, every backend
    r_ref, _ = B.run_reference(q6, db)
    r_loc, stats = B.run_local(q6, db, device=dev)
    out["revenue_reference"] = float(r_ref["revenue"][0])
    out["revenue_local"] = float(r_loc["revenue"][0])
    out["allreduces"] = stats.allreduces
    print(f"\nreference revenue = {out['revenue_reference']:,.2f}")
    print(f"local     revenue = {out['revenue_local']:,.2f}"
          f"   (allreduces={stats.allreduces})")
    np.testing.assert_allclose(np.asarray(r_loc["revenue"], np.float64),
                               np.asarray(r_ref["revenue"], np.float64),
                               rtol=1e-7)

    # a grouped example: the planner proves the hints Q1 used to hand-carry
    out["explain_q1"] = QUERIES[1].explain(db)
    print("\n" + out["explain_q1"])
    out["q1"], _ = B.run_local(QUERIES[1], db, device=dev)
    out["q1_flags"] = [str(f) for f in db.dicts["l_returnflag"][
        out["q1"]["l_returnflag"].astype(int)]]
    print("Q1 return flags decoded:", out["q1_flags"])
    return out


if __name__ == "__main__":
    main()
