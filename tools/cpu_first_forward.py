#!/usr/bin/env python3
"""Does a process's first CPU forward of the reduced LM equal its later ones?

    python3 tools/cpu_first_forward.py [--src DIR] [--runs N]

Starts ``N`` fresh Python processes, one after another.  Each imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``), builds the
model of ``tests/test_torch_gpu.py::test_model_forward_on_card_with_and_
without_kernel`` (the reduced Mistral-Nemo-12B config with 2 kv heads,
float32) on the CPU with weights from seed 0, and runs forward on that
test's tokens three times, recording the output of each attention and
norm step.  It reports how far the first forward lies from the second, how
many logits lie outside the test's limit (atol = rtol = 1e-4), whether the
second and third are equal bit for bit, and the first recorded step where
the first forward parts from the second, with the (batch, position) rows it
touches.  No card is used.  Prints a count per outcome and a total.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path


def one_process(src: str) -> dict:
    import dataclasses

    import torch
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("mistral_nemo_12b").reduced(),
                              n_kv_heads=2)
    model = Model(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(0))
    steps: list[list] = []

    def recorded(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            steps[-1].append((name, first.clone()))
            return out
        setattr(mod, name, wrapper)

    for mod, name in ((T, "rms_norm"), (A, "apply_rope"), (A, "_qkv"),
                      (A, "_sdpa"), (A, "gqa_forward")):
        recorded(mod, name)
    outs = []
    with torch.inference_mode():
        for _ in range(3):
            steps.append([])
            outs.append(model(tokens))
    c1, c2, c3 = outs
    d = (c1 - c2).abs()
    res = {"max_abs": float(d.max()),
           "over_limit": int((d > 1e-4 + 1e-4 * c2.abs()).sum()),
           "later_equal": torch.equal(c2, c3), "first_parting": None}
    for i, ((name, a), (_, b)) in enumerate(zip(steps[0], steps[1])):
        if not torch.equal(a, b):
            rows = torch.nonzero((a - b).abs() > 0)[:, :2]
            res["first_parting"] = {
                "step": i, "op": name, "max_abs": float((a - b).abs().max()),
                "batches": sorted(set(rows[:, 0].tolist())),
                "positions": [int(rows[:, 1].min()), int(rows[:, 1].max())]}
            break
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one_process(args.src)))
        return 0
    seen = collections.Counter()
    for _ in range(args.runs):
        out = subprocess.run([sys.executable, __file__, "--child", "--src",
                              args.src], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
        seen[out] += 1
    for line, n in seen.most_common():
        print(f"{n:4d} x {line}")
    parted = sum(n for line, n in seen.items()
                 if json.loads(line)["max_abs"] > 0)
    print(f"first forward parted from the second in {parted} of "
          f"{args.runs} processes ({args.src})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
