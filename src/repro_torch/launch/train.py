"""The trainer: the fault-tolerant train loop of ``repro.launch.train``
on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 6 --batch 4 \\
        --seq 1024            # Granite-MoE-3B in full on cuda

``--smoke`` trains the reduced config in float32 without remat; without it
the published config trains in bf16 with remat ``full``, the vocabulary
padded to a multiple of 128 and the experts unpadded (``expert_pad=1``: the
reference pads them to its mesh's ``model`` axis, which is 1 on one card).
The port's mesh is that one card, so ``--tp`` defaults to 1; ``--tp`` above
1, ``--multi-pod`` and ``--seq-parallel`` raise ``NotImplementedError``
(their shardings, ``distributed/shardings.py``, are the next item of
ROADMAP queue A).  Without ``--device`` it runs on ``cuda`` and raises where
there is none.

The loop checkpoints asynchronously (``CheckpointManager``, the last 2
kept), restores the latest step on restart and retries a failed step up to
``--max-retries`` times.  A retry is sound only before the in-place update
begins: the gradients are the step's own, so the step is simply run again;
a fault once the update has begun (``trainstep.UpdateFailed``) re-raises at
once.  The reference's functional update has no such window.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.table import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models import Model
from repro_torch.train import optimizer as optim
from repro_torch.train.trainstep import (GRAD_COMPRESS, UpdateFailed,
                                         init_train_state, make_train_step)


def main(argv: list[str] | None = None) -> dict:
    """Returns the arch, the restored step (0 if none), each step run with
    its loss and gradient norm, and the trained model and state."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_moe_3b_a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, float32")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compress", default="none", choices=GRAD_COMPRESS)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tp > 1 or args.multi_pod or args.seq_parallel:
        raise NotImplementedError(
            "--tp > 1, --multi-pod and --seq-parallel need the parameter and "
            "activation shardings (distributed/shardings.py), not yet ported "
            "(ROADMAP queue A); the port trains on one card")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg, device=dev,
                  dtype=torch.float32 if args.smoke else torch.bfloat16,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  expert_pad=1, vocab_pad=1 if args.smoke else 128,
                  remat="none" if args.smoke else "full")
    state = init_train_state(model, args.grad_compress)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev}")

    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, ocfg, args.grad_compress,
                              args.microbatch)
    params = dict(model.named_parameters())
    mgr = CheckpointManager(args.ckpt_dir, keep_last=2, async_save=True)
    start, restored, _ = mgr.restore_latest({"params": params,
                                             "state": state}, device=dev)
    if start is not None:
        model.load_state_dict(restored["params"])
        state = restored["state"]
        print(f"restored step {start}")
    start = start or 0

    rng = np.random.default_rng(0)
    out = {"arch": cfg.name, "start": start, "steps": [], "loss": [],
           "grad_norm": []}
    for step in range(start + 1, start + args.steps + 1):
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.seq)).astype(np.int32)).to(dev)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.frontend == "vision_patches":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.n_prefix, cfg.d_model), device=dev)
        for attempt in range(args.max_retries):
            try:
                metrics = step_fn(state, batch)
                break
            except UpdateFailed:
                raise
            except Exception as e:     # before the update: run it again
                if attempt == args.max_retries - 1:
                    raise
                print(f"step {step} attempt {attempt + 1} failed: {e};"
                      " retrying")
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out["steps"].append(step)
        out["loss"].append(loss)
        out["grad_norm"].append(gnorm)
        if step % 5 == 0 or step == start + 1:
            print(f"step {step:4d} loss={loss:.4f} gnorm={gnorm:.2f}")
        if step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "state": state},
                     {"loss": loss})
    mgr.wait()
    print("done")
    return {**out, "model": model, "state": state}


if __name__ == "__main__":
    main()
