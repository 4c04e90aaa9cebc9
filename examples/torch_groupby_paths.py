"""The three group_aggregate paths on one table, on the PyTorch port —
executable documentation.

The engine picks a grouped-aggregation path per group-by:

  sort    no hints needed            1 sort
  direct  provable key_bits          0 sorts (packed key IS the group id)
  hash    claimed groups_hint        0 sorts (device dictionary)

This script runs all three on the same table, proves they agree row for row,
and prints the sorts each one takes — counted as the sorting ``aten`` calls
it makes (``core/sortcount.SortCounter``; the reference counts HLO ``sort``
ops) — then shows the same choice being made by the planner on real TPC-H
plans (Q12's dictionary keys -> direct; Q13's data-dependent
orders-per-customer histogram -> hash).

    PYTHONPATH=src python examples/torch_groupby_paths.py [--sf 0.01] \
        [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import argparse

import numpy as np

from repro_torch.core import relational as R
from repro_torch.core.sortcount import SortCounter
from repro_torch.core.table import from_numpy, resolve_device, to_numpy
from repro_torch.data import tpch
from repro_torch.queries import QUERIES

AGGS = [("total", "sum", "v"), ("rows", "count", None),
        ("lo", "min", "v"), ("hi", "max", "v")]


def sorts(fn, *args):
    """(``fn(*args)``, the sorting calls it made)."""
    with SortCounter() as c:
        out = fn(*args)
    return out, len(c.calls)


def main(argv=None, db=None) -> dict:
    """Prints what the reference's example prints; returns each path's
    result and sort count and the planner's explanations of Q12 and Q13.
    ``db`` replaces the generated TPC-H database."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(7)
    n = 1000
    # keys drawn from a WIDE, data-dependent domain: the value range proves
    # nothing (up to 2^40), but the caller knows there are few distinct keys
    domain = rng.integers(0, 1 << 40, 64).astype(np.int64)
    keys = domain[rng.integers(0, 64, n)]
    vals = rng.normal(size=n)
    t = from_numpy({"k": keys, "v": vals}, capacity=1024, device=dev)
    # direct needs provable per-column bit widths -- here the honest claim
    # is 40 bits, far past DIRECT_AGG_BITS_MAX, so to show the path the
    # keys are remapped onto a provable 6-bit domain first
    remap = {int(k): i for i, k in enumerate(sorted(domain.tolist()))}
    t6 = from_numpy({"k": np.array([remap[int(k)] for k in keys],
                                   dtype=np.int64), "v": vals},
                    capacity=1024, device=dev)
    runs = {
        # sort: always available, pays ONE stable argsort
        "sort": (lambda t: R.group_aggregate(t, ["k"], AGGS, method="sort"),
                 t),
        "direct": (lambda t: R.group_aggregate(t, ["k"], AGGS, key_bits=[6],
                                               method="direct"), t6),
        # hash: needs only a distinct-group bound; keys stay 40-bit
        "hash": (lambda t: R.group_aggregate(t, ["k"], AGGS, method="hash",
                                             groups_hint=64,
                                             return_overflow=True)[0], t),
    }
    results, counts = {}, {}
    for name, (fn, arg) in runs.items():
        out, counts[name] = sorts(fn, arg)
        results[name] = to_numpy(out)

    print(f"{'path':8s} {'sorts':>9s} {'groups':>7s} {'sum(total)':>12s}")
    for name in ("sort", "direct", "hash"):
        r = results[name]
        print(f"{name:8s} {counts[name]:9d} {len(r['rows']):7d} "
              f"{r['total'].sum():12.4f}")

    # hash == sort (same 40-bit keys, ascending group order): the counts,
    # minima and maxima byte for byte; the float sums within the kernel's
    # tolerance against its oracle, 1e-9 (on the card the grouped sum adds
    # in its kernel's own fixed order, not the sort path's row order)
    for c in ("rows", "lo", "hi"):
        np.testing.assert_array_equal(results["hash"][c], results["sort"][c])
    np.testing.assert_allclose(results["hash"]["total"],
                               results["sort"]["total"], rtol=1e-9)
    # direct agrees on the remapped domain (same rows per group)
    np.testing.assert_array_equal(results["direct"]["rows"],
                                  results["sort"]["rows"])
    print("hash == sort (counts, min, max byte-identical; sums within "
          "1e-9); direct agrees on the remapped keys\n")

    # the planner makes the same choice from statistics + claims:
    if db is None:
        db = tpch.generate(args.sf, seed=args.seed)
    explain = {qid: QUERIES[qid].explain(db) for qid in (12, 13)}
    for text in explain.values():
        print(text)
    return {"results": results, "sorts": counts, "explain": explain}


if __name__ == "__main__":
    main()
