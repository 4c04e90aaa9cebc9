"""Batched serving driver on the PyTorch port: prefill a batch of prompts,
decode with sampling.

    PYTHONPATH=src python examples/torch_serve_lm.py \
        [--arch rwkv6_3b] [--tokens 32] [--device cpu]

Serves the reduced form of a config (default rwkv6_3b, as
``examples/serve_lm.py``) with random weights from a seeded generator,
float32, the experts unpadded (``expert_pad=1``, as there), sampling with a
seeded ``torch.Generator``.  Runs on ``cuda`` unless ``--device`` names
another device; without CUDA the default raises.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.table import resolve_device
from repro_torch.launch.serve_lm import generate
from repro_torch.models import Model


def main(argv=None) -> dict:
    """Prints what the reference's driver prints; returns the generated
    token ids and the prefill and decode times."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=dev, dtype=torch.float32, expert_pad=1,
                  generator=torch.Generator(device=dev).manual_seed(0))
    print(f"serving {cfg.name} (reduced) batch={args.batch}")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": torch.ones(
            (args.batch, cfg.n_prefix, cfg.d_model), device=dev)}
    gen = generate(model, prompts, args.tokens, args.temperature,
                   torch.Generator(device=dev).manual_seed(1), extra=extra)
    tokens = gen.tokens.cpu().numpy()
    print(f"prefill: {gen.prefill_s * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens")
    steps = args.tokens - 1         # the first token comes from prefill
    print(f"decode : {gen.decode_s * 1e3:.1f} ms for {steps} steps "
          f"({args.batch * steps / gen.decode_s:.1f} tok/s batch)")
    print("sampled token ids (first sequence):", tokens[0][:16].tolist())
    return {"arch": cfg.name, "prompts": prompts.numpy(), "tokens": tokens,
            "prefill_ms": gen.prefill_s * 1e3,
            "decode_ms": gen.decode_s * 1e3}


if __name__ == "__main__":
    main()
