"""The trainer: the fault-tolerant train loop of ``repro.launch.train``,
on one card or sharded over the launched world.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 6 --batch 4 \\
        --seq 1024            # Granite-MoE-3B in full on cuda
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --tp 2 --device cpu      # 4 gloo ranks, mesh (data 2, model 2)

Without ``--smoke`` the published config trains in bf16 with remat
``full`` and the vocabulary padded to a multiple of 128.  ``--smoke``
picks the reduced config in float32 without remat and changes nothing
else; the reference's ``--smoke`` also runs on a local mesh of (devices,
1), where here the mesh is always the launched world.  Without
``--device`` it runs on ``cuda`` and raises where there is none.

*The mesh.*  Where a process group exists (the caller's, which the
trainer reuses, or ``torchrun``'s, which it starts: nccl on ``cuda``, gloo
on ``cpu``) or ``--tp`` above 1, ``--multi-pod`` or ``--seq-parallel`` asks
for one (a single process then starts a group of one), the trainer runs
sharded (``distributed/shardings.py``): the mesh is the world, (world /
tp, tp) as (data, model), or (2, world / 2 tp, tp) as (pod, data, model)
under ``--multi-pod`` (a world that does not split so raises before any
group is made); the parameters are DTensors by the reference's rules, the
batch is sharded over the data axes, the activations are constrained
(``--seq-parallel`` shards the residual stream's sequence over ``model``)
and the experts are padded to the ``model`` size, as the reference's
``expert_pad``.  Otherwise it trains one unsharded model (``expert_pad``
1).  Every rank builds the same model from one seed and keeps its shards.

The loop checkpoints asynchronously (``CheckpointManager``, the last 2
kept; a sharded tree is gathered and rank 0 writes it), restores the latest
step on restart (onto the mesh of this run) and retries a failed step up
to ``--max-retries`` times.  A retry is sound only before the in-place
update begins: the gradients are the step's own, so the step is simply run
again; a fault once the update has begun (``trainstep.UpdateFailed``)
re-raises at once.  The reference's functional update has no such window.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import comm
from repro_torch.core.table import resolve_device
from repro_torch.distributed import shardings as sh
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch.mesh import mesh_shape, world_mesh
from repro_torch.models import Model
from repro_torch.train import optimizer as optim
from repro_torch.train.trainstep import (GRAD_COMPRESS, UpdateFailed,
                                         init_train_state, make_train_step)


def main(argv: list[str] | None = None) -> dict:
    """Returns the arch, the restored step (0 if none), each step run with
    its loss, gradient norm and seconds (host clock, the loss read back),
    and the trained model, state and mesh (None unsharded)."""
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
    dev = resolve_device(args.device)
    sharded = (dist.is_initialized() or "WORLD_SIZE" in os.environ or
               args.tp > 1 or args.multi_pod or args.seq_parallel)
    made_group = False
    if sharded:
        world = dist.get_world_size() if dist.is_initialized() else \
            int(os.environ.get("WORLD_SIZE", "1"))
        mesh_shape(world, args.tp, args.multi_pod)    # raises if it cannot
        dev, made_group = comm.join_world(dev)
    try:
        return _train(args, dev, sharded)
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, dev: torch.device, sharded: bool) -> dict:
    rank = dist.get_rank() if sharded else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = constrain = None
    if sharded:
        mesh = world_mesh(dist.get_world_size(), args.tp, args.multi_pod,
                          dev.type)
        axes = sh.MeshAxes(fsdp=("pod", "data") if args.multi_pod
                           else ("data",), tp="model")
        constrain = sh.make_constrain(mesh, axes, args.seq_parallel)
    model = Model(cfg, device=dev,
                  dtype=torch.float32 if args.smoke else torch.bfloat16,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  expert_pad=args.tp if sharded else 1,
                  vocab_pad=1 if args.smoke else 128,
                  remat="none" if args.smoke else "full",
                  constrain=constrain)
    if sharded:
        sh.distribute_model(model, mesh, axes)
    state = init_train_state(model, args.grad_compress)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev}"
        + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
           if sharded else ""))

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
        say(f"restored step {start}")
    start = start or 0

    rng = np.random.default_rng(0)
    out = {"arch": cfg.name, "start": start, "steps": [], "loss": [],
           "grad_norm": [], "step_s": []}
    for step in range(start + 1, start + args.steps + 1):
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.seq)).astype(np.int32)).to(dev)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.frontend == "vision_patches":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.n_prefix, cfg.d_model), device=dev)
        if sharded:
            batch = sh.distribute_tree(batch, sh.batch_specs(axes, batch),
                                       mesh)
        t0 = time.perf_counter()
        for attempt in range(args.max_retries):
            try:
                metrics = step_fn(state, batch)
                break
            except UpdateFailed:
                raise
            except Exception as e:     # before the update: run it again
                if attempt == args.max_retries - 1:
                    raise
                say(f"step {step} attempt {attempt + 1} failed: {e};"
                    " retrying")
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out["step_s"].append(time.perf_counter() - t0)   # read back: synced
        out["steps"].append(step)
        out["loss"].append(loss)
        out["grad_norm"].append(gnorm)
        if step % 5 == 0 or step == start + 1:
            say(f"step {step:4d} loss={loss:.4f} gnorm={gnorm:.2f}")
        if step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "state": state},
                     {"loss": loss})
    mgr.wait()
    say("done")
    return {**out, "model": model, "state": state, "mesh": mesh}


if __name__ == "__main__":
    main()
