#!/usr/bin/env python3
"""Hold the sharded LM path to the unsharded one on four CPU ranks of one
gloo group, where the mesh cuts what a one-card mesh cannot: heads that the
model axis does not divide, caches cut on their batch or their sequence,
the MoE's dispatch with its expert stacks kept in place or gathered.

    python3 tools/check_sharded_cpu.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
nothing of JAX, so it runs on any host with torch, e.g. beside the card to
check that host's torch.  Reduced configs in float32 with the port's own
weights from seed 3, the same on every rank and on the unsharded copy:

* on mesh (data 1, model 4), Granite-MoE with six heads over two KV heads
  and RWKV6 (two heads): the forward, one AdamW train step and decodes of
  batch 3 (six heads over four ranks, a KV group straddling two of them)
  and 1 (a batch of one over a data axis of one rank);
* on mesh (data 2, model 2), decode: Zamba2 and RWKV6 at batch 1 (the caches
  cut on their sequence over data), DeepSeek-V2 at batch 2 (MLA, the
  experts kept in place); Granite's forward at 4 x 160 tokens (the experts'
  stacks gathered).

Each is within relative L2 ``TOL`` of the unsharded model (logits; the loss,
the gradients' global norm and the parameters after the step).  Prints one
JSON line with every reading and torch's version; exits 1 if one is over.
``tests/test_torch_sharded.py`` runs the same cases on its own group with
the reference's weights (each case function's ``state``) and holds the
sharded outputs that each returns to the reference's as well.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SEED = 3
TOL = 1e-5
B, S = 4, 8
UNEVEN = {"granite_moe_3b_a800m": {"n_heads": 6, "n_kv_heads": 2},
          "rwkv6_3b": {}}
DECODE = [("zamba2_1_2b", 1), ("rwkv6_3b", 1), ("deepseek_v2_236b", 2)]
PROMPT, STEPS = 6, 2
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
GATHER_SEQ = 160


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def config(arch, over):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch).reduced(), **over)


def _models(arch, mesh, over, state=None):
    """(config, unsharded, sharded) models in float32 with the experts
    padded to the mesh's model size: the weights from seed ``SEED``, or the
    state dict ``state``."""
    import torch
    from repro_torch.distributed import shardings as sh
    from repro_torch.models import Model
    cfg = config(arch, over)
    tp = mesh.shape[mesh.mesh_dim_names.index("model")]
    kw = dict(device="cpu", dtype=torch.float32, expert_pad=tp)
    plain = Model(cfg, generator=torch.Generator().manual_seed(SEED), **kw)
    if state is not None:
        plain.load_state_dict(state)
    sharded = Model(cfg, constrain=sh.make_constrain(mesh, sh.MeshAxes()),
                    **kw)
    sharded.load_state_dict(plain.state_dict())
    sh.distribute_model(sharded, mesh, sh.MeshAxes())
    return cfg, plain, sharded


def tokens_of(cfg, batch, seq):
    import torch
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=g)


# Each case function returns {"readings": against the unsharded model,
# "outputs": the sharded model's, whole}.

def forward(arch, mesh, over, seq=S, state=None) -> dict:
    import torch
    from repro_torch.distributed import shardings as sh
    cfg, plain, sharded = _models(arch, mesh, over, state)
    tokens = tokens_of(cfg, B, seq)
    with torch.no_grad():
        want = plain(tokens)
        got = sharded(sh.shard_like(tokens, mesh,
                                    sh.Spec("data", None))).full_tensor()
    return {"readings": {"logits": _rel(got, want)},
            "outputs": {"logits": got}}


def train_step(arch, mesh, over, state=None) -> dict:
    from repro_torch.distributed import shardings as sh
    from repro_torch.train import optimizer, trainstep
    cfg, plain, sharded = _models(arch, mesh, over, state)
    tokens = tokens_of(cfg, B, S)
    batch = {"tokens": tokens, "labels": tokens}
    ocfg = optimizer.AdamWConfig(**ADAMW)
    want = trainstep.make_train_step(plain, ocfg)(
        trainstep.init_train_state(plain), batch)
    got = trainstep.make_train_step(sharded, ocfg)(
        trainstep.init_train_state(sharded),
        sh.distribute_tree(batch, sh.batch_specs(sh.MeshAxes(), batch), mesh))
    params = dict(plain.named_parameters())
    new = {name: p.full_tensor() for name, p in sharded.named_parameters()}
    diff = total = 0.0
    for name, p in new.items():
        diff += (p.double() - params[name].double()).square().sum().item()
        total += params[name].double().square().sum().item()
    loss, norm = got["loss"].item(), got["grad_norm"].item()
    return {"readings": {"loss": abs(loss / want["loss"].item() - 1),
                         "grad_norm": abs(norm / want["grad_norm"].item()
                                          - 1),
                         "params": (diff / total) ** 0.5},
            "outputs": {"loss": loss, "grad_norm": norm, "params": new}}


def decode(arch, mesh, over, batch, state=None) -> dict:
    import torch
    from repro_torch.distributed import shardings as sh
    cfg, plain, sharded = _models(arch, mesh, over, state)
    tokens = tokens_of(cfg, batch, PROMPT + STEPS)
    n = PROMPT + STEPS
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    like = sharded.init_cache(batch, n, dtype=torch.float32)
    cache = sh.distribute_tree(like, sh.cache_specs(
        cfg, like, sh.MeshAxes(), batch, shape), mesh)
    ref_cache = plain.init_cache(batch, n, dtype=torch.float32)
    spec = sh.Spec("data", None) if batch >= shape["data"] else \
        sh.Spec(None, None)
    errs, outs = [], []
    with torch.no_grad():
        want, ref_cache = plain.prefill(tokens[:, :PROMPT], ref_cache)
        got, cache = sharded.prefill(
            sh.shard_like(tokens[:, :PROMPT], mesh, spec), cache)
        outs.append(got.full_tensor())
        errs.append(_rel(outs[-1], want))
        for pos in range(PROMPT, n):
            tok = tokens[:, pos:pos + 1]
            want, ref_cache = plain.decode(tok, ref_cache, pos)
            got, cache = sharded.decode(sh.shard_like(tok, mesh, spec),
                                        cache, pos)
            outs.append(got.full_tensor())
            errs.append(_rel(outs[-1], want))
    # the prefill's logits, then each step's
    return {"readings": {"logits": max(errs)}, "outputs": {"logits": outs}}


def _cases():
    for arch, over in UNEVEN.items():
        yield f"{arch} model 4 forward", (1, 4), forward, (arch, over)
        yield f"{arch} model 4 train", (1, 4), train_step, (arch, over)
        for batch in (3, 1):
            yield (f"{arch} model 4 decode b{batch}", (1, 4), decode,
                   (arch, over, batch))
    for arch, batch in DECODE:
        yield f"{arch} 2x2 decode b{batch}", (2, 2), decode, (arch, {}, batch)
    yield ("granite_moe_3b_a800m 2x2 forward, stacks gathered", (2, 2),
           forward, ("granite_moe_3b_a800m", {}, GATHER_SEQ))


def _worker(rank: int, tmp: str, src: str) -> None:
    import torch
    import torch.distributed as dist
    sys.path.insert(0, src)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    from repro_torch.launch.mesh import make_mesh
    out = {}
    meshes = {}
    try:
        for name, shape, fn, args in _cases():
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
            try:
                out[name] = fn(args[0], meshes[shape], *args[1:])[
                    "readings"]
            except Exception:       # every rank fails alike
                out[name] = {"error": traceback.format_exc()[-2000:]}
    finally:
        if rank == 0:
            with open(os.path.join(tmp, "out.json"), "w") as f:
                json.dump(out, f)
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(tmp, args.src), nprocs=WORLD)
        with open(os.path.join(tmp, "out.json")) as f:
            out = json.load(f)
    bad = [name for name, res in out.items()
           if "error" in res or max(res.values()) > TOL]
    print(json.dumps({"torch": torch.__version__, "tol": TOL, "bad": bad,
                      "readings": out}))
    return 1 if bad or len(out) != len(list(_cases())) else 0


if __name__ == "__main__":
    sys.exit(main())
