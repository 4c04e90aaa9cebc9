"""Reduce results/torch/dryrun/*.json (the LM dry-run's records,
``launch/dryrun.py``) into the §Dry-run/§Roofline tables, and
results/runs/*.json (fault-runner RunReports) into the per-attempt audit
table (markdown on stdout).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16]
    PYTHONPATH=src python -m repro_torch.launch.report --section runs

The port's own copy of the reference package's report: pure Python, it
renders the port's ``RunReport`` (rung and CI width included).  The
dry-run table reads the port's record keys: ``flops`` and
``traffic_bytes`` per device and the host seconds of a cell (``host_s``),
where the reference's records hold ``hlo_flops``, ``hlo_bytes`` and
``compile_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch", "dryrun")
RUNS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                    "results", "runs")


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _file_tag(path: str) -> str:
    base = os.path.basename(path)[:-5]
    parts = base.split("__")
    mesh_tag = parts[2] if len(parts) > 2 else ""
    for m in ("2x16x16", "16x16"):
        if mesh_tag.startswith(m):
            return mesh_tag[len(m):].lstrip("_")
    return ""


def load(mesh: str | None = None, tag: str = ""):
    recs = []
    for f in sorted(glob.glob(os.path.join(RESULTS, "*.json"))):
        if _file_tag(f) != tag:
            continue
        r = json.load(open(f))
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def roofline_table(recs):
    print("| arch | shape | mesh | bottleneck | compute | memory | collective"
          " | step LB | roofline | useful FLOPs | collectives |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("skipped"):
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                  f"*skipped* | - | - | - | - | - | - | {r['skipped'][:46]} |")
            continue
        if not r.get("ok"):
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAILED** "
                  f"| - | - | - | - | - | - | {r.get('error', '')[:40]} |")
            continue
        rf = r["roofline"]
        cc = r.get("collective_count", {})
        cstr = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in
                        sorted(cc.items()))
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {rf['bottleneck']} "
              f"| {rf['compute_s'] * 1e3:.1f}ms "
              f"| {rf['memory_s'] * 1e3:.1f}ms "
              f"| {rf['collective_s'] * 1e3:.1f}ms "
              f"| {rf['step_lower_bound_s'] * 1e3:.1f}ms "
              f"| {100 * rf.get('roofline_frac', 0):.1f}% "
              f"| {100 * rf.get('useful_flop_frac', 0):.0f}% "
              f"| {cstr} |")


def dryrun_table(recs):
    print("| arch | shape | mesh | host | flops/dev | traffic/dev |"
          " collective bytes/dev | temp bytes | arg bytes |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if not r.get("ok"):
            continue
        mem = r.get("memory", {})
        cb = sum(r.get("collective_bytes", {}).values())
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {r.get('host_s', 0):.0f}s "
              f"| {r['flops']:.2e} | {fmt_bytes(r['traffic_bytes'])} "
              f"| {fmt_bytes(cb)} "
              f"| {fmt_bytes(mem.get('temp_bytes'))} "
              f"| {fmt_bytes(mem.get('argument_bytes'))} |")


def run_report_record(query, report) -> dict:
    """JSON-able record of one ``QueryRunner.run`` audit trail
    (:class:`repro_torch.distributed.fault.RunReport`) for results/runs/."""
    return {"query": str(query), "attempts": report.rows(),
            "injected": [dataclasses.asdict(f) for f in report.injected]}


def load_runs():
    return [json.load(open(f))
            for f in sorted(glob.glob(os.path.join(RUNS, "*.json")))]


def _fmt_ci(ci) -> str:
    """CI half-width cell: '-' when not an approx attempt, 'inf' when the
    sample could not support a variance estimate."""
    if ci is None:
        return "-"
    ci = float(ci)
    if ci != ci or ci == float("inf"):
        return "inf"
    return f"{100 * ci:.2f}%"


def run_report_table(recs):
    """Per-attempt audit of fault-runner executions: what failed, where the
    chaos harness injected it, which sample-ladder rung answered (approx
    runs), and how the policy recovered."""
    print("| query | attempt | outcome | cut | factor | wire | inference |"
          " rung | ci | wall | backoff | snapshots | devices | gen |"
          " error |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        for a in r.get("attempts", []):
            rung = a.get("rung", 0)
            print(f"| {r.get('query', '?')} | {a['attempt']} "
                  f"| {a['outcome']} "
                  f"| {a.get('cut') or '-'} "
                  f"| {a['capacity_factor']:.2f} "
                  f"| {a.get('wire_format') or 'env'} "
                  f"| {'on' if a.get('inference', True) else 'off'} "
                  f"| {f'1/{rung}' if rung else 'exact'} "
                  f"| {_fmt_ci(a.get('ci_width'))} "
                  f"| {a['wall_s'] * 1e3:.0f}ms "
                  f"| {a['backoff_s'] * 1e3:.0f}ms "
                  f"| {a.get('snapshots_reused', 0)} "
                  f"| {a.get('devices', 0) or '-'} "
                  f"| {a.get('generation', 0)} "
                  f"| {a.get('error', '')[:40]} |")


def serve_table():
    """One-line markdown digest of ``BENCH_serve.json`` (repo root)."""
    path = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "BENCH_serve.json")
    r = json.load(open(path))
    print("| sf | requests | templates | recompiles | cache hits |"
          " shared hits | cold | warm q/s | batch q/s | pass |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    print(f"| {r['sf']} | {r['requests']} | {r['templates']} "
          f"| {r['recompiles']} | {r['cache_hits']} | {r['shared_hits']} "
          f"| {r['cold_s']:.2f}s | {r['serve_qps']} | {r['batch_qps']} "
          f"| {'yes' if r['pass'] else 'NO'} |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--section", default="roofline",
                    choices=["roofline", "dryrun", "runs", "serve"])
    args = ap.parse_args()
    if args.section == "runs":
        run_report_table(load_runs())
        return
    if args.section == "serve":
        serve_table()
        return
    recs = load(args.mesh, args.tag)
    if args.section == "roofline":
        roofline_table(recs)
    else:
        dryrun_table(recs)


if __name__ == "__main__":
    main()
