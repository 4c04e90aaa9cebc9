"""Batched serving driver: prefill a batch of prompts, then decode with
sampling, as ``examples/serve_lm.py`` of the reference does.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--arch rwkv6_3b] \\
        [--tokens 32] [--device cpu]

The CLI serves the reduced form of any assigned config (default rwkv6_3b,
as the reference's example) with random weights and the experts unpadded
(``expert_pad=1``, as the reference's example); without ``--device`` it
runs on ``cuda`` and raises where there is none.
:func:`generate` is the entry point the chip smoke run drives at full width.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor       # (B, n) int64 generated ids
    prefill_s: float           # prompt prefill and the first token
    decode_s: float            # the n - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: Model, prompts: torch.Tensor, tokens: int,
             temperature: float, generator: torch.Generator,
             extra: dict | None = None) -> Generation:
    """Prefill ``prompts`` (B, P), take the argmax as the first new token,
    then decode ``tokens - 1`` more, each drawn with ``torch.multinomial``
    from ``softmax(logits / temperature)`` with ``generator``.  Runs on the
    model's device; the times are host clock around work that ends in a
    device synchronize."""
    dev = model.device
    prompts = torch.as_tensor(prompts, device=dev)
    b, p = prompts.shape
    n_prefix = 0
    if model.cfg.frontend == "vision_patches":
        n_prefix = extra["patches"].shape[1]
    cache = model.init_cache(b, n_prefix + p + tokens + 8)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache, extra=extra)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    pos0 = n_prefix + p
    for i in range(tokens - 1):
        logits, cache = model.decode(tok, cache, pos0 + i)
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), t1 - t0, t2 - t1)


def main(argv: list[str] | None = None) -> Generation:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=args.device, dtype=torch.float32, expert_pad=1)
    dev = model.device
    print(f"serving {cfg.name} (reduced) batch={args.batch} on {dev}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    extra = None
    if cfg.frontend == "vision_patches":
        extra = {"patches": torch.ones((args.batch, cfg.n_prefix,
                                        cfg.d_model), device=dev)}
    gen = generate(model, prompts, args.tokens, args.temperature,
                   torch.Generator(device=dev).manual_seed(1), extra=extra)
    print(f"prefill: {gen.prefill_s * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens")
    print(f"decode : {gen.decode_s * 1e3:.1f} ms for {args.tokens - 1} steps "
          f"({args.batch * (args.tokens - 1) / gen.decode_s:.1f} tok/s batch)")
    print("sampled token ids (first sequence):",
          gen.tokens[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
