"""Serving bench: prepared templates against a cold preparation per
request.

Multi-tenant serving (``repro_torch.serve``) prepares each of the 22 TPC-H
templates once (its PlanInfo, plan and settings, closed over by a
``run(tables, pvals)``); a request binds parameter values as 0-d tensors
into the standing preparation.  This drives a mixed, interleaved stream
(every sample binding of every template, round-robin so consecutive
requests come from different templates) through:

  * ``server``      -- :class:`repro_torch.serve.QueryServer`: bind, cached
                       preparation, device run per request;
  * ``batch``       -- :class:`repro_torch.serve.BatchExecutor`: the stream
                       as one batch with the cross-query subplan memo;
  * ``per_prepare`` -- (``--baseline``) the no-serving baseline: every
                       request pays a cold preparation, on a server whose
                       database view has empty planner caches (the column
                       statistics kept, the resident tables shared).  The
                       eager engine has no trace, so this is the
                       counterpart of the reference's per-request jit.

Times are the least of ``--reps`` stream passes after the cold pass (which
is where every preparation happens, reported as ``cold_s``).

    PYTHONPATH=src python -m repro_torch.bench.bench_serve [--check]

Writes ``--out`` (default ``results/torch/bench_serve.json``).  ``--check``
exits non-zero unless the preparations (``recompiles``) equal the distinct
templates of the stream, the batch shared a subplan across queries, no
request re-ran on overflow, and every parameterized template was bound at
least twice.
"""
from __future__ import annotations

import time

from repro_torch import serve
from repro_torch.core import backend as B
from repro_torch.core import planner

from .common import Datasets, best_of, open_device, parser, write_report


def stream():
    """Every sample of all 22 templates, round-robin, so consecutive
    requests come from different templates (the serving-unfriendly
    order)."""
    per = [[(t, s) for s in t.samples]
           for _, t in sorted(serve.TEMPLATES.items())]
    out, i = [], 0
    while any(per):
        if per[i % len(per)]:
            out.append(per[i % len(per)].pop(0))
        i += 1
    return out


def per_prepare(db, reqs, dev) -> None:
    """Each request on a fresh server over a fresh view of ``db``: a cold
    PlanInfo and preparation per request.  The view holds ``db``'s column
    statistics and shares its resident device tables, so what each request
    pays beyond a warm one is the preparation alone."""
    stats = planner.column_stats(db)
    for t, s in reqs:
        view = B.derive_database(db, {})
        with planner.stats_override(view, stats):
            serve.QueryServer(view, device=dev).submit(t, s)


def main(argv=None, data: Datasets | None = None) -> dict:
    ap = parser(__doc__, sf=0.05, seed=7, out="bench_serve")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--baseline", action="store_true",
                    help="also time the cold-preparation-per-request "
                         "baseline")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless recompiles == distinct "
                         "templates (and batch sharing happened)")
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    db = (data or Datasets()).tpch(args.sf, args.seed)
    reqs = stream()
    n_templates = len({id(t) for t, _ in reqs})
    n_param = sum(1 for t in serve.TEMPLATES.values() if t.params)

    srv = serve.QueryServer(db, device=dev)
    t0 = time.perf_counter()
    srv.serve(reqs, infer=True)          # cold pass: every template prepares
    cold_s = time.perf_counter() - t0
    serve_s = best_of(lambda: srv.serve(reqs, infer=True), dev, args.reps)

    bx = serve.BatchExecutor(db, device=dev)
    batch_s = best_of(lambda: bx.run_batch(reqs, infer=True), dev, args.reps)

    per_prepare_s = None
    if args.baseline:
        per_prepare_s = best_of(lambda: per_prepare(db, reqs, dev), dev, 1)

    bindings_per_template = {
        t.name: len(t.samples) for t, _ in reqs if t.params}
    checks = {
        # one preparation per template, however many bindings or passes
        "one_preparation_per_template": srv.recompiles == n_templates,
        "cross_query_sharing": bx.shared_hits > 0,
        "no_overflow_reruns": srv.overflow_reruns == 0,
        "multi_binding_coverage": all(
            n >= 2 for n in bindings_per_template.values()),
    }
    ok = all(checks.values())
    report = {
        "sf": args.sf, "seed": args.seed, "reps": args.reps,
        "device": label,
        "requests": len(reqs), "templates": n_templates,
        "parameterized_templates": n_param,
        "recompiles": srv.recompiles, "cache_hits": srv.cache_hits,
        "shared_hits": bx.shared_hits,
        "cold_s": cold_s, "serve_s": serve_s,
        "serve_qps": len(reqs) / serve_s,
        "batch_s": batch_s, "batch_qps": len(reqs) / batch_s,
        "per_prepare_s": per_prepare_s,
        "checks": checks, "pass": bool(ok),
    }
    print(f"{len(reqs)} requests over {n_templates} templates "
          f"({n_param} parameterized) on {label}: cold {cold_s:.3f}s, "
          f"warm {serve_s:.4f}s ({report['serve_qps']:.1f} q/s), "
          f"batch {batch_s:.4f}s ({report['batch_qps']:.1f} q/s)")
    print(f"recompiles={srv.recompiles} cache_hits={srv.cache_hits} "
          f"shared_hits={bx.shared_hits}")
    if per_prepare_s is not None:
        print(f"per-request cold preparation baseline {per_prepare_s:.4f}s "
              f"({len(reqs) / per_prepare_s:.1f} q/s)")
    for name, passed in checks.items():
        print(f"  {'ok ' if passed else 'FAIL'} {name}")
    write_report(args.out, report)
    if args.check and not ok:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
