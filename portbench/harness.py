"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

The system under test is ``repro_torch.serve.QueryServer``; the harness
reaches it only through its public surface (``QueryServer``, ``submit``,
its counters, ``repro_torch.kernels.build``), so that a later change to the
program's insides leaves the harness working.  One closed-loop client sends
the cell's traffic; a request's latency is the host's clock around
``submit``, which returns the answer on the host, so the device's work is
inside it.

Set-up: the kernels' build (only a checkout's first run compiles), the data
made on the card from the seed (``data/<generator>.py``), the host-side
column statistics, the server (it uploads the tables), and a first pass that
sends every distinct request of the cycle once (each template's one
preparation and every binding's shapes).  The window then only binds and
runs, for ``--seconds`` and on to the end of the pass of the traffic's
order under way then, so that every run measures whole passes.  With
``--trace 1`` the window runs under the profiler, also in whole
passes, then one cycle runs under the counting
hooks of the metrics that count (``PASS = "count"``); only per-layer
metrics are reported.

After the window the program's state is freed, and the reference
(``reference/<reference>.py``, plain PyTorch) answers every distinct
request that was served; every served answer is compared with it
(``compare.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np

from . import catalog, compare as C, loadgen, profiling

__all__ = ["main", "run_cell", "Served", "Outcome"]

PEAK_BYTES_PER_S = 3.35e12      # one H100 SXM's HBM3, NVIDIA's data sheet
TRACE_CAP_S = 10.0              # the longest traced window
BANNED = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Served(NamedTuple):
    """One request as the client saw it."""
    key: str
    qid: int
    binding: dict
    latency_s: float
    answer: dict | None
    error: str | None


class Outcome(NamedTuple):
    result: dict            # the result line's object; "checks" last
    setup: dict             # part -> seconds


def _program_server(tables, dicts, scale, device):
    """The system under test, built from the generated columns."""
    t = time.perf_counter()
    from repro_torch.core import planner
    from repro_torch.core.table import Database
    from repro_torch.serve import QueryServer
    parts = {"program_import_s": time.perf_counter() - t}
    db = Database(tables, dicts, scale)
    t = time.perf_counter()
    stats = getattr(planner, "column_stats", None)
    if stats is not None:
        stats(db)
    parts["stats_s"] = time.perf_counter() - t
    t = time.perf_counter()
    server = QueryServer(db, device=device)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    parts["upload_s"] = time.perf_counter() - t

    def free():
        invalidate = getattr(planner, "invalidate_stats", None)
        if invalidate is not None:
            invalidate(db)
    return server, parts, free


def _send(server, req: loadgen.Request, span: bool = False) -> Served:
    ctx = contextlib.nullcontext()
    if span:
        from torch.profiler import record_function
        ctx = record_function(profiling.SPAN_PREFIX + req.key)
    t0 = time.perf_counter()
    try:
        with ctx:
            ans = server.submit(req.qid, dict(req.binding))
        err = None
    except Exception as e:     # a failed request is counted, not fatal
        ans, err = None, f"{type(e).__name__}: {e}"
    return Served(req.key, req.qid, req.binding, time.perf_counter() - t0,
                  ans, err)


def _window(server, reqs, seconds: float, whole_passes: int = 0,
            span: bool = False) -> tuple[list[Served], float]:
    """Send ``reqs`` round and round until ``seconds`` have passed (and, if
    ``whole_passes``, until a multiple of that many requests is done)."""
    out: list[Served] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        out.append(_send(server, reqs[i % len(reqs)], span))
        i += 1
        if time.perf_counter() - t0 >= seconds and \
                (not whole_passes or i % whole_passes == 0):
            break
    return out, time.perf_counter() - t0


def _card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    limit = "unknown"
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        if got.returncode == 0 and got.stdout.strip():
            limit = got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": limit}


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             server_factory: Callable | None = None,
             root: Path = catalog.ROOT,
             setup: dict[str, float] | None = None) -> Outcome:
    """One run of ``workload``.  ``server_factory(tables, dicts, scale,
    device)`` returns ``(server, setup parts, free)``; the default builds
    the program's server.  The tests pass others (a planted fault, the
    control)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = catalog.load_cell(workload, root)
    cfg, mix = cell.config, cell.traffic
    setup = dict(setup or {})

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    setup["cuda_init_s"] = time.perf_counter() - t
    if dev.type == "cuda" and server_factory is None:
        from repro_torch import kernels as K
        t = time.perf_counter()
        built = K.build()
        setup["kernel_build_s"] = time.perf_counter() - t
        log("kernel build: " + json.dumps({k: round(v, 3)
                                           for k, v in built.items()}))

    gen = catalog.module("data", cfg["generator"])
    t = time.perf_counter()
    tables, dicts = gen.generate(cfg["scale_factor"], seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        # the peak is the server's: the generator's scratch is gone
        torch.cuda.reset_peak_memory_stats(dev)
    setup["generate_s"] = time.perf_counter() - t
    host_gb = sum(v.nbytes for cols in tables.values()
                  for v in cols.values()) / 1e9

    factory = server_factory or _program_server
    server, parts, free = factory(tables, dicts, cfg["scale_factor"], dev)
    setup.update(parts)
    resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    reqs = loadgen.cycle(mix, seed)
    distinct = list({r.key: r for r in reqs}.values())
    t = time.perf_counter()
    first = [_send(server, r) for r in distinct]
    setup["first_pass_s"] = time.perf_counter() - t
    prepared = getattr(server, "recompiles", None)
    t_window = time.perf_counter()
    setup["setup_s"] = t_window - t_start
    log("setup: " + json.dumps({k: round(v, 3) for k, v in setup.items()}))
    log(f"tables: {host_gb:.3f} GB on the host, {resident / 1e9:.3f} GB "
        f"resident on the device after the upload; {len(distinct)} distinct "
        f"requests, preparations {prepared}")

    per_layer: dict[str, Any] = {}
    breakdown = None
    device_extra: dict[str, float] = {}
    if not trace:
        # whole passes of the mix's order, so that every run measures the
        # same mix of templates however its seconds end
        served, window_s = _window(server, reqs, seconds,
                                   whole_passes=len(mix["order"]))
    else:
        served, window_s, per_layer, breakdown, device_extra = _traced(
            cell, server, reqs, seconds, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0

    # the program's state goes before the reference runs
    del server
    free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_mod = catalog.module("reference", cfg["reference"])
    refdb = ref_mod.RefDB(tables, dicts, cfg["scale_factor"], dev,
                          torch.float64)
    answers = {}
    for s in first + served:
        if s.key not in answers:
            answers[s.key] = ref_mod.answer(refdb, s.qid, s.binding)
    del refdb
    ref_s = time.perf_counter() - t

    limits = cfg["limits"]
    gap_limit = float(limits["gap"])
    wrong_rows, raised, failed, max_gap = 0, 0, 0, 0.0
    first_error = None
    for timed, s in [(False, s) for s in first] + [(True, s) for s in served]:
        if s.error is not None:
            raised += 1
            failed += timed
            first_error = first_error or f"{s.key}: {s.error}"
            continue
        w, g = C.compare(s.answer, answers[s.key], ref_mod.ORDER[s.qid],
                         gap_limit)
        wrong_rows += w
        max_gap = max(max_gap, g)
        failed += timed and (w > 0 or g > gap_limit)
    if first_error:
        log(f"first failed request: {first_error}")
    log(f"reference: {len(answers)} distinct answers in {ref_s:.2f} s, "
        f"{len(first) + len(served)} answers compared")

    lat = [s.latency_s for s in served]
    ok = [s for s in served if s.error is None]
    checks = {
        "raised": {"value": raised, "limit": int(limits.get("raised", 0))},
        "wrong_rows": {"value": wrong_rows,
                       "limit": int(limits.get("wrong_rows", 0))},
        "max_gap": {"value": max_gap, "limit": gap_limit},
    }
    correct = bool(served) and all(c["value"] <= c["limit"]
                                   for c in checks.values())

    metrics: dict[str, dict] = {}
    if not trace:
        values = {
            "qps": len(ok) / window_s,
            "latency_geomean_ms": math.exp(float(np.mean(np.log(
                np.asarray(lat) * 1e3)))),
            "latency_p95_ms": _pct(lat, 95) * 1e3,
            "setup_s": setup["setup_s"],
        }
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        _describe_latency(served)
    else:
        for m in cell.per_layer:
            if per_layer.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": per_layer[m["name"]],
                                      "unit": m["unit"]}
    log(f"window: {len(served)} requests in {window_s:.3f} s, "
        f"{len(served) - len(ok)} raised; peak {peak / 1e9:.3f} GB")

    card = _card(dev)
    card["memory_peak_bytes"] = peak
    card.update(device_extra)
    result = {"correct": correct, "attempted": len(served), "failed": failed,
              "metrics": metrics, "device": card}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return Outcome(result, setup)


def _describe_latency(served: list[Served]) -> None:
    """Per template: count, median and p95 of its latencies, and which
    template the window's p95 falls in."""
    by: dict[str, list[float]] = {}
    for s in served:
        by.setdefault(f"q{s.qid}", []).append(s.latency_s * 1e3)
    lat = sorted(s.latency_s * 1e3 for s in served)
    p95 = _pct(lat, 95)
    rows = {k: [len(v), round(_pct(v, 50), 3), round(_pct(v, 95), 3)]
            for k, v in sorted(by.items(), key=lambda kv: -np.median(kv[1]))}
    at = min(served, key=lambda s: abs(s.latency_s * 1e3 - p95))
    log(f"latency ms by template [n, median, p95]: {json.dumps(rows)}")
    log(f"p95 {p95:.3f} ms lies in q{at.qid}'s latencies")


def _traced(cell, server, reqs, seconds, dev):
    """The traced window (profiler, and the hooks of ``PASS = "profile"``
    metrics), then one cycle under the hooks of ``PASS = "count"``
    metrics.  Returns the served requests of both, the window's seconds,
    the per-layer readings, the breakdown and ``busy_s`` / ``window_s``."""
    from torch.profiler import record_function
    readers = {m["name"]: catalog.reader(m["name"]) for m in cell.per_layer}
    rec = Record(dev, server)
    n_pass = len(cell.traffic["order"])
    box: dict = {}

    def window():
        with contextlib.ExitStack() as hooks:
            for r in readers.values():
                if getattr(r, "PASS", "profile") == "profile" and \
                        hasattr(r, "install"):
                    hooks.enter_context(r.install(rec))
            rec.counters_before = _counters(server)
            with record_function(profiling.WINDOW_SPAN):
                box["served"], box["s"] = _window(
                    server, reqs, min(seconds, TRACE_CAP_S),
                    whole_passes=n_pass, span=True)
            rec.counters_after = _counters(server)

    if dev.type == "cuda":
        rec.trace = profiling.trace(window, log)
    else:
        window()
    rec.requests, rec.window_s = box["served"], box["s"]
    with contextlib.ExitStack() as hooks:
        for r in readers.values():
            if getattr(r, "PASS", "profile") == "count" and \
                    hasattr(r, "install"):
                hooks.enter_context(r.install(rec))
        rec.count_requests, _ = _window(server, reqs, 0.0,
                                        whole_passes=len(reqs))
    readings = {}
    for name, r in readers.items():
        v = r.read(rec)
        readings[name] = None if v is None else float(v)
    for note in rec.notes:
        log(note)
    extra, breakdown = {}, None
    if rec.trace is not None:
        extra = {"busy_s": profiling.busy_s(rec.trace),
                 "window_s": (rec.trace.window.end_ns -
                              rec.trace.window.start_ns) / 1e9}
        breakdown = {"device_ops": profiling.device_ops(rec.trace),
                     "idle_gaps": profiling.idle_gaps(rec.trace)}
    served = rec.requests + rec.count_requests
    return served, rec.window_s, readings, breakdown, extra


def _counters(server) -> dict:
    return {k: getattr(server, k) for k in
            ("recompiles", "cache_hits", "overflow_reruns")
            if isinstance(getattr(server, k, None), int)}


class Record:
    """What the per-layer readers read: the traced window's requests and
    seconds, the trace, the server's counters around the window, the
    counting cycle's requests, and whatever a reader's hook stored in
    ``extras``.  ``notes`` are printed on the run's standard error."""

    def __init__(self, device, server):
        self.device = device
        self.server = server
        self.trace: profiling.Trace | None = None
        self.requests: list[Served] = []
        self.window_s = 0.0
        self.count_requests: list[Served] = []
        self.counters_before: dict = {}
        self.counters_after: dict = {}
        self.extras: dict = {}
        self.notes: list[str] = []
        self.peak_bytes_per_s = PEAK_BYTES_PER_S


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must never
    load (the JAX package and JAX itself), compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def main(argv: list[str] | None = None, t_start: float | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t = time.perf_counter()
    import torch
    setup = {"torch_import_s": time.perf_counter() - t}
    if t_start is not None:
        setup["before_main_s"] = t - t_start
    cell = catalog.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ". Nothing is measured on the CPU.")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start, setup=setup)
    found = banned_modules()
    if found:
        log(f"portbench: the run loaded {found}; the benchmark may load "
            "neither JAX nor the JAX package")
        return 3
    for name, c in out.result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out.result), flush=True)
    return 0
