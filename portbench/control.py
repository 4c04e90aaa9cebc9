"""The control of the comparison: the reference itself, computed one
precision below the configuration's (float32 for float64), put in the
program's place.  A comparison that cannot tell this from the reference
cannot tell a program that drops to that precision either, so it must come
out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--program-seeds 4,5,...]

runs, on the card and at the cell's own size, the control on each of
``--seeds`` and the program on each of ``--program-seeds``, each through
the harness with a window of ``--seconds``, all in one process, and prints
each run's compared numbers (one JSON line each) and their extremes: the
program's largest (the lower reading of each limit) and the control's
smallest (the upper).  The benchmark's own runs never run it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build",
                                                  "triton_cache")

from portbench import catalog  # noqa: E402


class ControlServer:
    """Answers requests with the reference in ``dtype``."""

    def __init__(self, tables, dicts, scale, device, reference: str,
                 dtype):
        self._ref = catalog.module("reference", reference)
        self._db = self._ref.RefDB(tables, dicts, scale, device, dtype)

    def submit(self, qid, binding):
        return self._ref.answer(self._db, qid, binding)


def factory(reference: str):
    """A ``server_factory`` for ``harness.run_cell`` that puts the float32
    reference in the program's place."""
    import torch

    def make(tables, dicts, scale, device):
        return (ControlServer(tables, dicts, scale, device, reference,
                              torch.float32), {}, lambda: None)
    return make


def main(argv=None) -> int:
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = catalog.load_cell(args.workload)
    runs = [("control", int(s)) for s in args.seeds.split(",") if s] + \
        [("program", int(s)) for s in args.program_seeds.split(",") if s]
    worst: dict = {}
    for side, seed in runs:
        t = time.perf_counter()
        make = factory(cell.config["reference"]) if side == "control" \
            else None
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               args.device, server_factory=make)
        vals = {k: c["value"] for k, c in out.result["checks"].items()}
        print(json.dumps({"side": side, "seed": seed,
                          "correct": out.result["correct"], **vals,
                          "setup": out.setup,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in vals.items():
            w = worst.setdefault(side, {})
            w[k] = (max if side == "program" else min)(w.get(k, v), v)
    print(json.dumps({"program_largest": worst.get("program"),
                      "control_smallest": worst.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
