"""What the port's benches share: arguments, the device and its label,
timing that waits for the device, CSV lines, reports and generated data.

Timing: a host clock around work that ends in ``torch.cuda.synchronize()``
(for a whole query or exchange), CUDA events for a kernel
(:func:`kernel_ms`).  Every timed line names the device it was taken on
(:func:`device_label`: the card's name and power limit, or ``cpu``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core.table import resolve_device
from repro_torch.data import jcch, tpch

__all__ = ["ROOT", "RESULTS", "emit", "parser", "device_label", "sync",
           "time_fn", "best_of", "kernel_ms", "Datasets", "write_report",
           "open_device"]

# <checkout>/results/torch: the benches' JSON reports (``results/`` is in
# .gitignore); the reference's BENCH_*.json at the root are never written
ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "torch"


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def parser(doc: str, sf: float | None = None, seed: int | None = None,
           out: str | None = None) -> argparse.ArgumentParser:
    """The arguments every bench takes (``--device``), with ``--sf``,
    ``--seed`` and ``--out`` (default ``results/torch/<out>.json``) where
    given defaults."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    if sf is not None:
        ap.add_argument("--sf", type=float, default=sf)
    if seed is not None:
        ap.add_argument("--seed", type=int, default=seed)
    if out is not None:
        ap.add_argument("--out", default=str(RESULTS / f"{out}.json"))
    return ap


def device_label(dev: torch.device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi`` gives
    them, joined by `` @ `` (the CSV's derived column holds no comma)."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)} @ power limit not read"
    name, _, limit = out.splitlines()[0].rpartition(",")
    return f"{name.strip()} @ {limit.strip()}"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _walls(fn, dev: torch.device, warmup: int, iters: int) -> list[float]:
    for _ in range(warmup):
        fn()
    sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return ts


def time_fn(fn, dev: torch.device, warmup: int = 2, iters: int = 5) -> float:
    """Median wall seconds of ``fn()`` after ``warmup`` calls, the device
    synchronised after each call."""
    return statistics.median(_walls(fn, dev, warmup, iters))


def best_of(fn, dev: torch.device, reps: int, warmup: int = 0) -> float:
    """Least wall seconds of ``reps`` calls of ``fn()``, the device
    synchronised after each call."""
    return min(_walls(fn, dev, warmup, reps))


def kernel_ms(fn, dev: torch.device, reps: int = 5, warmup: int = 1
              ) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after ``warmup``: from CUDA
    events on the card, from the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Datasets:
    """Generated databases, one per (generator, sf, seed, skew), shared by
    the benches of one run: generation is set-up, made once.  A caller
    that already holds a database hands it over with :meth:`add`."""

    def __init__(self):
        self._dbs: dict[tuple, object] = {}

    def add(self, db, sf: float, seed: int) -> None:
        self._dbs["tpch", float(sf), int(seed), 0.0] = db

    def tpch(self, sf: float, seed: int):
        key = ("tpch", float(sf), int(seed), 0.0)
        if key not in self._dbs:
            self._dbs[key] = tpch.generate(sf, seed=seed)
        return self._dbs[key]

    def jcch(self, sf: float, seed: int, skew: float):
        key = ("jcch", float(sf), int(seed), float(skew))
        if key not in self._dbs:
            self._dbs[key] = jcch.generate(sf, seed=seed, skew=skew)
        return self._dbs[key]


def write_report(path: str, report: dict) -> None:
    """Write ``report`` as JSON to ``path`` (its directory made) and say
    so, with the report's verdict where it has one."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    verdict = f"  pass={report['pass']}" if "pass" in report else ""
    print(f"wrote {out}{verdict}", flush=True)


def open_device(name: str) -> tuple[torch.device, str]:
    """The bench's device (``cuda`` unless asked for another; raises
    without CUDA) and its label, printed once as a comment line."""
    dev = resolve_device(name)
    label = device_label(dev)
    print(f"# device: {label}", flush=True)
    return dev, label
