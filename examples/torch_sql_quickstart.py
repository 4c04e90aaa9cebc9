"""SQL quickstart on the PyTorch port: an ad-hoc (non-TPC-H) query through
the whole stack.

Takes SQL text the repo has never seen, parses it, prints the canonical
form back, lowers + optimizes it into a logical plan, inspects what the
planner derives (exchange counts, placement validation, per-exchange wire
bytes), then runs the SAME compiled query on the NumPy reference backend
and the PyTorch local backend and checks they agree.

    PYTHONPATH=src python examples/torch_sql_quickstart.py [--sf 0.01] \
        [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import argparse

import numpy as np

from repro_torch.core import backend as B
from repro_torch.core import planner as PL
from repro_torch.core.table import resolve_device
from repro_torch.data import tpch
from repro_torch.sql import compile_sql, parse
from repro_torch.sql.ast import format_query

SQL = """
select n_name,
       count(*) as suppliers,
       sum(s_acctbal) as total_bal,
       sum(case when s_acctbal < 0.0 then 1.0 else 0.0 end) as in_debt
from supplier
join nation on s_nationkey = n_nationkey
where s_acctbal < 9000.0
group by n_name
order by total_bal desc
limit 5
"""


def main(argv=None, db=None) -> dict:
    """Prints what the reference's SQL quickstart prints; returns the
    canonical form, the static counts, notes and wire bytes, and both
    backends' results.  ``db`` replaces the generated database."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if db is None:
        db = tpch.generate(args.sf, seed=args.seed)

    canonical = format_query(parse(SQL))
    print("canonical form (parse -> print round trip):")
    print(canonical)
    print()

    q = compile_sql(SQL, name="supplier_balance")
    counts, notes, wire = q.static_counts(), PL.validate(q.plan, db), \
        q.static_wire(db)
    print("static exchange counts (no execution):", counts)
    print("placement validation notes:", notes or "clean")
    for e in wire:
        print(f"  {e['kind']}: {e['row_wire_bytes']} B/row on the wire "
              f"({e['row_logical_bytes']} B logical, {e['wire']})")

    r_ref, stats = B.run_reference(q, db)
    assert counts == stats.counts(), "static != runtime counts"
    r_loc, _ = B.run_local(q, db, device=dev)

    print("\n top nations by supplier balance (reference backend):")
    for i in range(len(r_ref["n_name"])):
        name = db.dicts["n_name"][int(np.asarray(r_ref["n_name"])[i])]
        print(f"  {name:<16} suppliers={int(np.asarray(r_ref['suppliers'])[i]):>4} "
              f"total_bal={float(np.asarray(r_ref['total_bal'])[i]):>12.2f} "
              f"in_debt={int(np.asarray(r_ref['in_debt'])[i]):>3}")

    for k in r_ref:
        np.testing.assert_allclose(np.asarray(r_loc[k], np.float64),
                                   np.asarray(r_ref[k], np.float64),
                                   rtol=1e-9, err_msg=k)
    print("\nreference == local: OK")
    return {"canonical": canonical, "static_counts": counts, "notes": notes,
            "wire": wire, "reference": r_ref, "local": r_loc}


if __name__ == "__main__":
    main()
