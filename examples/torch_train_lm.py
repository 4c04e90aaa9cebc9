"""End-to-end training on the PyTorch port: train a small LM for a
few hundred steps with checkpoint/restart.

Default is a ~10M-parameter model (the config's reduced form); ``--full``
trains the ~100M configuration (same code path, longer wall time).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 50] [--full] \\
        [--arch mistral_nemo_12b] [--grad-compress bf16] [--device cpu]

Weights from a seeded generator, float32, experts unpadded, as
``examples/train_lm.py``; batches from the same numpy zipf stream.  Runs on
``cuda`` unless ``--device`` names another device; without CUDA the
default raises.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.table import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models import Model
from repro_torch.train import optimizer as optim
from repro_torch.train.trainstep import init_train_state, make_train_step


def synthetic_batch(rng, vocab, batch, seq, device="cpu"):
    """Zipfian token stream with local structure (learnable bigrams)."""
    base = rng.zipf(1.5, size=(batch, seq)).clip(1, vocab - 2)
    shifted = np.roll(base, 1, axis=1) + 1
    mix = rng.random((batch, seq)) < 0.5
    tokens = np.where(mix, base, shifted % (vocab - 1)).astype(np.int32)
    tokens = torch.from_numpy(tokens).to(device)
    return {"tokens": tokens, "labels": tokens}


def main(argv=None) -> dict[int, float]:
    """Prints what the reference's example prints; returns the printed
    losses by step."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mistral_nemo_12b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if args.full:
        cfg = dataclasses.replace(cfg, n_layers=12, d_model=640, n_heads=8,
                                  n_kv_heads=4, head_dim=80, d_ff=1536,
                                  vocab=32064)
    model = Model(cfg, device=dev, dtype=torch.float32, expert_pad=1,
                  generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"compress={args.grad_compress}")

    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10,
                             total_steps=args.steps)
    state = init_train_state(model, args.grad_compress)
    step_fn = make_train_step(model, ocfg, args.grad_compress)
    params = dict(model.named_parameters())

    mgr = CheckpointManager(args.ckpt_dir, keep_last=2, async_save=True)
    start, restored, _ = mgr.restore_latest({"params": params,
                                             "state": state}, device=dev)
    if start is not None:
        model.load_state_dict(restored["params"])
        state = restored["state"]
        print(f"restored from step {start}")
    start = start or 0

    rng = np.random.default_rng(0)
    losses = {}
    t0 = time.perf_counter()
    for step in range(start + 1, start + args.steps + 1):
        batch = synthetic_batch(rng, cfg.vocab, args.batch, args.seq, dev)
        metrics = step_fn(state, batch)
        if step % 10 == 0 or step == start + 1:
            dt = time.perf_counter() - t0
            losses[step] = float(metrics["loss"])
            print(f"step {step:4d}  loss={losses[step]:.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"lr={float(metrics['lr']):.2e}  {dt:.1f}s")
        if step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "state": state},
                     {"loss": float(metrics["loss"])})
    mgr.wait()
    print(f"done; checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
