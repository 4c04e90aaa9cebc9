#!/usr/bin/env python3
"""Does a process's first CPU forward of the reduced LM equal its later ones?

    python3 tools/cpu_first_forward.py [--src DIR] [--runs N]

Starts ``N`` fresh Python processes, one after another.  Each imports
``repro_torch`` from ``DIR`` (default: this checkout's ``src``), builds the
model of ``tests/test_torch_gpu.py::test_model_forward_on_card_with_and_
without_kernel`` (the reduced Mistral-Nemo-12B config with 2 kv heads,
float32) on the CPU with weights from seed 0, and runs forward on that
test's tokens three times, recording the inputs and output of each norm,
RoPE, QKV, attention and block step (a few clones a step, so that the
recording moves the process's allocations little).  It reports how far the
first forward lies from the second, how many logits lie outside the test's
limit (atol = rtol = 1e-4), whether the second and third are equal bit for
bit, and the first step where the first forward parts from the second
(``first_parting``): its name, the (batch, position) rows it touches,
whether its inputs were still equal (then the step itself computed
otherwise), and which of the two outputs it gives when run again on the
first forward's inputs.  Beside it, layer 0's query product x @ wq of each
forward against float64.  No card is used.  Prints the host's CPU and math libraries, a
count per outcome and a total.
"""
from __future__ import annotations

import argparse
import collections
import json
import platform
import subprocess
import sys
from pathlib import Path

_CPU_FLAGS = ("avx2", "avx512f", "avx512_bf16", "avx512_fp16", "amx_bf16",
              "amx_tile", "amx_fp16", "amx_int8")


def host() -> dict:
    """The CPU and the math libraries this process's torch runs on."""
    import torch
    model, flags = platform.processor(), set()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
            elif line.startswith("flags"):
                flags = set(line.split(":", 1)[1].split())
                break
    except OSError:
        pass
    info = torch.__config__.parallel_info().splitlines()
    return {"cpu": model, "flags": [f for f in _CPU_FLAGS if f in flags],
            "torch": torch.__version__,
            "capability": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads(),
            "libraries": [s.strip() for s in info
                          if "Math Kernel" in s or "MKL-DNN" in s]}


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

    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recorded(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            steps[-1].append((name, fn, [clone(a) for a in args], kwargs,
                              first.clone()))
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

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def tensors_equal(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys)
                   if isinstance(x, torch.Tensor))

    with torch.inference_mode():
        # layer 0's query product: the first apply_rope's input is x @ wq
        wq = model.layers[0].attn["wq"].double()
        x0 = [s[0][4] for s in steps[:2]]            # layer 0's first norm
        q0 = [next(st[2][0] for st in s if st[0] == "apply_rope")
              for s in steps[:2]]
        exact = (x0[0].double() @ wq).reshape(q0[0].shape)
        res["query_product"] = {
            "norm_equal": torch.equal(*x0), "equal": torch.equal(*q0),
            "err_vs_float64": [float((q.double() - exact).abs().max())
                               for q in q0]}
        for i, (a, b) in enumerate(zip(steps[0], steps[1])):
            name, fn, args, kwargs, out1 = a
            if torch.equal(out1, b[4]):
                continue
            again = first(fn(*args, **kwargs))
            rows = torch.nonzero((out1 - b[4]).abs() > 0)
            res["first_parting"] = {
                "step": i, "op": name,
                "max_abs": float((out1 - b[4]).abs().max()),
                "elements": int(rows.shape[0]),
                "batches": sorted(set(rows[:, 0].tolist())),
                "positions": [int(rows[:, 1].min()), int(rows[:, 1].max())],
                "inputs_equal": tensors_equal(args, b[2]),
                "rerun_equals": "first" if torch.equal(again, out1) else
                "second" if torch.equal(again, b[4]) else "neither"}
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
    print(json.dumps(host()), flush=True)
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
