"""Attention of the dense blocks: GQA/MQA with RoPE, an optional QKV bias and
the prefix-LM mask, as the GQA half of ``repro.models.attention``.

Training-style forward and prefill run on full (B, S, D); decode takes one
token against a static-capacity KV cache (B, L, KV, hd).  The reference
updates its cache functionally; here the cache tensors are written in
place, which keeps one copy of each layer's cache alive.  MLA (DeepSeek-V2)
is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import NEG_INF
from .common import ArchConfig, apply_rope, dense_init


def _at_pos(cache_arr: torch.Tensor, update: torch.Tensor,
            pos: int) -> torch.Tensor:
    """Write ``update`` into ``cache_arr`` at (0, pos, 0, ...), in place."""
    cache_arr[:, pos:pos + update.shape[1]] = update.to(cache_arr.dtype)
    return cache_arr


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------

def init_gqa(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype) -> nn.ParameterDict:
    """wq (d, H hd), wk and wv (d, KV hd), wo (H hd, d): the reference's
    (in, out) layout, applied as ``x @ w``; biases start at zero."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (d, h * hd), dtype),
         "wk": dense_init(gen, (d, kv * hd), dtype),
         "wv": dense_init(gen, (d, kv * hd), dtype),
         "wo": dense_init(gen, (h * hd, d), dtype)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=gen.device)
    return nn.ParameterDict({k: nn.Parameter(w, requires_grad=False)
                             for k, w in p.items()})


def _qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,L,KV,hd), mask (B,S,L) or None; float32
    scores and softmax, the output in q's dtype."""
    b, s, h, hd = q.shape
    _, l, kv, _ = k.shape
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_mask(b: int, s: int, n_prefix: int = 0,
                device: torch.device | str | None = None) -> torch.Tensor:
    """(B, S, S) bool: key j visible from query i when j <= i, or when j is
    in the bidirectional prefix (prefix-LM)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if n_prefix:
        m = m | (j < n_prefix)
    return m.expand(b, s, s)


def gqa_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                n_prefix: int = 0, use_flash_kernel: bool = False
                ) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if use_flash_kernel and n_prefix == 0:
        # the blocked online-softmax kernel (csrc/flash_attention.cu on the
        # card, its plain version on the CPU)
        o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
        o = o.transpose(1, 2)
    else:
        o = _sdpa(q, k, v, causal_mask(b, s, n_prefix, x.device),
                  1.0 / (cfg.hd ** 0.5))
    return o.reshape(b, s, -1) @ p["wo"]


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device | str
                  ) -> dict[str, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device)}


def gqa_prefill(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: dict[str, torch.Tensor], n_prefix: int = 0):
    """Full forward (plain attention, as the reference's prefill) and the
    cache prefix written."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    cache = {"k": _at_pos(cache["k"], k, 0), "v": _at_pos(cache["v"], v, 0)}
    o = _sdpa(q, k, v, causal_mask(b, s, n_prefix, x.device),
              1.0 / (cfg.hd ** 0.5))
    return o.reshape(b, s, -1) @ p["wo"], cache


def gqa_decode(p, cfg: ArchConfig, x: torch.Tensor,
               cache: dict[str, torch.Tensor], pos: int):
    """x (B, 1, D); attend over cache[:, : pos + 1]."""
    b = x.shape[0]
    l = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    ck = _at_pos(cache["k"], k, pos)
    cv = _at_pos(cache["v"], v, pos)
    mask = (torch.arange(l, device=x.device) <= pos).expand(b, 1, l)
    o = _sdpa(q, ck, cv, mask, 1.0 / (cfg.hd ** 0.5))
    return o.reshape(b, 1, -1) @ p["wo"], {"k": ck, "v": cv}
