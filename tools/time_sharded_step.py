#!/usr/bin/env python3
"""Time Granite-MoE-3B's train step through ``launch/train.py`` on one CUDA
card, unsharded and then sharded on a one-rank mesh (data 1 x model 1), as
``chip_smoke.py``'s phases 13 and 14(b) run it, and its bf16 forward with
the flash kernel, unsharded and sharded, as phase 14(c) runs it.

    python3 tools/time_sharded_step.py [--src DIR] [--steps N] [--batch B]
        [--seq S] [--reps R]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script times another checkout of the port, e.g. a parent commit
unpacked with ``git archive``.  Both runs build the model in full (bf16,
remat full) from seed 0 and train ``--steps`` steps (default 5) of B x S
(default 4 x 1024) random tokens; the sharded run joins a one-rank NCCL
group first, so every parameter is a DTensor and every layer runs the
sharded path (``models/common.on_shards``, the MoE's sharded dispatch).
The forward (B 2 x S 4096, seed 0, deterministic algorithms on, as 14(c))
is timed ``--reps`` times (default 5) after one warm call, each call
synchronised, and one more sharded call is profiled: its host time, the
device time of its kernels and copies, the ten host operations that took
the most host time of their own and the six kernels with the most device
time.  Prints one JSON line: each run's step times, their median over
steps 2 on, the losses and peak device memory, the forwards' times and
their median, the profile, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_moe_3b_a800m"
PREFILL = (2, 4096)


def run(dev, steps: int, batch: int, seq: int) -> dict:
    import torch
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        res = train.main(["--arch", ARCH, "--steps", str(steps), "--batch",
                          str(batch), "--seq", str(seq), "--ckpt-dir", tmp,
                          "--ckpt-every", "1000"])
    torch.cuda.synchronize(dev)
    walls = [s * 1e3 for s in res["step_s"]]
    out = {"step_ms": [round(w, 1) for w in walls],
           "median_ms": round(statistics.median(walls[1:]), 1),
           "loss": [round(x, 4) for x in res["loss"]],
           "peak_GB": round(torch.cuda.max_memory_allocated(dev) / 1e9, 2)}
    del res
    torch.cuda.empty_cache()
    return out


def forward(dev, mesh, reps: int) -> dict:
    """The bf16 forward with the flash kernel, on ``mesh`` (sharded) or
    unsharded (``mesh`` None)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import shardings as sh
    from repro_torch.models import Model
    cfg = get_config(ARCH)
    b, s = PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(2))
    axes = sh.MeshAxes()
    model = Model(cfg, device=dev, dtype=torch.bfloat16, expert_pad=1,
                  use_flash_kernel=True,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  constrain=sh.make_constrain(mesh, axes) if mesh else None)
    if mesh is not None:
        model = sh.distribute_model(model, mesh, axes)
        tokens = sh.shard_like(tokens, mesh, sh.Spec("data", None))
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    walls = []
    with torch.no_grad():
        model(tokens)
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            t0 = time.perf_counter()
            model(tokens)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        out = {"ms": [round(w, 1) for w in walls],
               "median_ms": round(statistics.median(walls), 1)}
        if mesh is not None:
            out["profile"] = _profile(dev, lambda: model(tokens))
    torch.use_deterministic_algorithms(deterministic)
    del model
    torch.cuda.empty_cache()
    return out


def _profile(dev, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time of its kernels and copies (the trace's device records,
    summed), the ten host operations with the most host time of their own
    (ms, calls) and the six kernels with the most device time (ms,
    launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for k in prof.profiler.kineto_results.events():
        if k.device_type() == DeviceType.CUDA:
            row = kernels.setdefault(k.name(), [0.0, 0])
            row[0] += k.duration_ns() / 1e6
            row[1] += 1
    rows = prof.key_averages()
    top = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)
    return {"wall_ms": round(wall, 1),
            "device_ms": round(sum(ms for ms, _ in kernels.values()), 1),
            "host_self_ms": round(sum(r.self_cpu_time_total
                                      for r in rows) / 1e3, 1),
            "top_host_ops": [[r.key, round(r.self_cpu_time_total / 1e3, 1),
                              r.count] for r in top[:10]],
            "top_kernels": [[name[:120], round(ms, 1), n] for name, (ms, n)
                            in sorted(kernels.items(),
                                      key=lambda kv: -kv[1][0])[:6]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("time_sharded_step: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    unsharded = run(dev, args.steps, args.batch, args.seq)
    fwd_unsharded = forward(dev, None, args.reps)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        sharded = run(dev, args.steps, args.batch, args.seq)
        from repro_torch.launch.mesh import world_mesh
        fwd_sharded = forward(dev, world_mesh(1, 1, False, "cuda"),
                              args.reps)
    finally:
        dist.destroy_process_group()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "arch": ARCH,
                      "batch": args.batch, "seq": args.seq,
                      "unsharded": unsharded, "sharded": sharded,
                      "forward": {"batch": PREFILL[0], "seq": PREFILL[1],
                                  "unsharded": fwd_unsharded,
                                  "sharded": fwd_sharded}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
