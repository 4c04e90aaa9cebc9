"""Plain PyTorch version of blocked attention: dense softmax attention with
the causal mask and the GQA head map, as
``repro.kernels.flash_attention.ref.attention_ref`` computes it.

Scores in float32, masked entries set to -1e30, a max-subtracted softmax,
the output in q's dtype.  The CPU path of ``ops.flash_attention``, and what
the chip smoke run holds the kernel against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BKV, Skv, D), BH = BKV * group: flattened query
    head ``bh`` reads kv head ``bh // group``."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
