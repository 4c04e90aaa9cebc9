"""Attention variants of ``repro.models.attention``: GQA/MQA with RoPE, an
optional QKV bias and the prefix-LM mask, and MLA (DeepSeek-V2's low-rank
KV compression, whose cache holds the latent only).

Training-style forward and prefill run on full (B, S, D); decode takes one
token against a static-capacity cache: (B, L, KV, hd) keys and values for
GQA, the (B, L, kv_lora_rank) latent and the (B, L, 1, qk_rope_dim) shared
rotary key for MLA.  The reference updates its cache functionally; here the
cache tensors are written in place, which keeps one copy of each layer's
cache alive.  MLA runs the plain attention whatever ``use_flash_kernel``
says, as the reference's does.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import NEG_INF
from .common import (ArchConfig, apply_rope, cut_dims, dense_init, merge_dim,
                     on_mesh, on_shards, param_dict, rms_norm, split_dim)


def _at_pos(cache_arr: torch.Tensor, update: torch.Tensor,
            pos: int) -> torch.Tensor:
    """Write ``update`` into ``cache_arr`` at (0, pos, 0, ...), in place.
    A DTensor cache cut on its sequence (batch-1 long decode) is written
    locally, each rank the positions it holds: DTensor would gather the
    whole sequence to write a slice of it."""
    seq = cut_dims(cache_arr, 1)
    if not seq:
        cache_arr[:, pos:pos + update.shape[1]] = update.to(cache_arr.dtype)
        return cache_arr
    mesh = cache_arr.device_mesh
    pl = [Replicate() if i in seq else p
          for i, p in enumerate(cache_arr.placements)]
    upd = update.to(cache_arr.dtype).redistribute(mesh, pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache_arr.shape, mesh, cache_arr.placements)
    lo = max(pos, offset[1])
    hi = min(pos + upd.shape[1], offset[1] + shape[1])
    if lo < hi:
        cache_arr.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            upd[:, lo - pos:hi - pos]
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
    return param_dict(p)


def _qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(split_dim(q, 2, h), positions, cfg.rope_theta)
    # KV heads that the model axis does not divide stay whole over it, as
    # the cache holds them; each rank reads its query heads' share
    k = apply_rope(split_dim(k, 2, kv, recut=False), positions,
                   cfg.rope_theta)
    return q, k, split_dim(v, 2, kv, recut=False)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,L,KV,hd), mask (B,S,L) or None; float32
    scores and softmax, the output in q's dtype (on each rank's shards for
    DTensors: ``on_shards``' rows are the queries, its keys the keys)."""
    kv = [(k, 0, 2, None, 1), (v, 0, 2, None, 1)]
    if mask is None:
        return on_shards(lambda q, k, v, **kw: _sdpa_local(q, k, v, None,
                                                           scale, **kw),
                         (0, 2, 1), (q, 0, 2, 1), *kv, balance=True)
    return on_shards(lambda q, k, v, m, **kw: _sdpa_local(q, k, v, m, scale,
                                                          **kw),
                     (0, 2, 1), (q, 0, 2, 1), *kv,
                     (on_mesh(mask, q), 0, None, 1, 2), balance=True)


def _sdpa_local(q, k, v, mask, scale: float, key_groups=()) -> torch.Tensor:
    """The attention on local tensors; with ``key_groups`` (the keys cut
    over those groups, which ``on_shards`` plans only without a gradient) the
    softmax's max and sum are reduced over them and the result is this
    rank's share of the sum over its keys."""
    kv = k.shape[2]                 # 0 on a rank past the heads' shards
    qg = q.reshape(*q.shape[:2], kv, q.shape[2] // max(kv, 1), q.shape[3])
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    if key_groups:
        top = scores.amax(dim=-1, keepdim=True)
        for g in key_groups:
            top = funcol.all_reduce(top, "max", g)
        w = torch.exp(scores - top)
        total = w.sum(dim=-1, keepdim=True)
        for g in key_groups:
            total = funcol.all_reduce(total, "sum", g)
        w = w / total
    else:
        w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v.float())
    return out.reshape(q.shape).to(q.dtype)                  # (B,S,H,hd)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """Causal flash attention on (B, S, H, hd) q and (B, L, KV, hd) k, v."""
    return fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True).transpose(1, 2)


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
        # card, its plain version on the CPU), given a DTensor's local
        # shards: its wrapper takes raw pointers
        # (its causal mask starts at query 0: balanced by batch only)
        o = on_shards(_flash, (0, 2), (q, 0, 2), (k, 0, 2), (v, 0, 2),
                      balance=True)
    else:
        o = _sdpa(q, k, v, causal_mask(b, s, n_prefix, x.device),
                  1.0 / (cfg.hd ** 0.5))
    return merge_dim(o, 2) @ p["wo"]


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
    return merge_dim(o, 2) @ p["wo"], cache


def gqa_decode(p, cfg: ArchConfig, x: torch.Tensor,
               cache: dict[str, torch.Tensor], pos: int):
    """x (B, 1, D); attend over cache[:, : pos + 1]."""
    b = x.shape[0]
    l = cache["k"].shape[1]
    positions = on_mesh(torch.full((b, 1), pos, dtype=torch.int64,
                                   device=x.device), x)
    q, k, v = _qkv(p, cfg, x, positions)
    ck = _at_pos(cache["k"], k, pos)
    cv = _at_pos(cache["v"], v, pos)
    mask = (torch.arange(l, device=x.device) <= pos).expand(b, 1, l)
    o = _sdpa(q, ck, cv, mask, 1.0 / (cfg.hd ** 0.5))
    return merge_dim(o, 2) @ p["wo"], {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank KV compression; the cache holds the latent only
# ---------------------------------------------------------------------------

def init_mla(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype) -> nn.ParameterDict:
    """The query's and the key-value's down and up projections, their RMS
    norm scales (zero at init) and wo, in the reference's (in, out)
    layout."""
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    z = lambda n: torch.zeros(n, dtype=dtype, device=gen.device)
    return param_dict({
        "wq_a": dense_init(gen, (d, cfg.q_lora_rank), dtype),
        "q_norm": z(cfg.q_lora_rank),
        "wq_b": dense_init(gen, (cfg.q_lora_rank, h * qd), dtype),
        "wkv_a": dense_init(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                            dtype),
        "kv_norm": z(cfg.kv_lora_rank),
        "wkv_b": dense_init(gen, (cfg.kv_lora_rank,
                                  h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                            dtype),
        "wo": dense_init(gen, (h * cfg.v_head_dim, d), dtype)})


def _mla_qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """-> q_nope (B,S,H,nd), q_rope (B,S,H,rd), the normed latent c_kv
    (B,S,kv_lora_rank) and the rotated shared key k_rope (B,S,1,rd)."""
    b, s, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps,
                 cfg.norms_f32) @ p["wq_b"]
    q = split_dim(q, 2, cfg.n_heads)                         # (B,S,H,nd+rd)
    q_nope = q[..., :nd]
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps,
                    cfg.norms_f32)
    k_rope = apply_rope(kv_a[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope,
                mask: torch.Tensor | None) -> torch.Tensor:
    """Expand the latent to per-head keys and values and attend, (B,S,*)
    against (B,L,*): float32 scores and softmax, the output in q's dtype,
    then wo."""
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    kv = split_dim(c_kv @ p["wkv_b"], 2, cfg.n_heads)        # (B,L,H,nd+vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    scale = 1.0 / ((nd + rd) ** 0.5)
    args = [(q_nope, 0, 2), (q_rope, 0, 2), (k_nope, 0, 2),
            (k_rope, 0, None), (v, 0, 2)]                # one shared key head
    if mask is not None:
        args.append((on_mesh(mask, q_nope), 0, None))
    o = on_shards(lambda *t: _mla_scores(*t, scale=scale), (0, 2), *args,
                  balance=True)
    return merge_dim(o, 2) @ p["wo"]


def _mla_scores(q_nope, q_rope, k_nope, k_rope, v, mask=None, *,
                scale: float) -> torch.Tensor:
    """MLA's attention on per-head keys and values: float32 scores and
    softmax -> (B,S,H,vd) in q's dtype."""
    s_nope = torch.einsum("bshd,blhd->bhsl", q_nope.float(), k_nope.float())
    s_rope = torch.einsum("bshd,blkd->bhsl", q_rope.float(), k_rope.float())
    scores = (s_nope + s_rope) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhsl,blhd->bshd", w, v.float()).to(q_nope.dtype)


def mla_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                n_prefix: int = 0, use_flash_kernel: bool = False
                ) -> torch.Tensor:
    """The plain attention whatever ``use_flash_kernel`` says, as the
    reference's."""
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    return _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                       causal_mask(b, s, n_prefix, x.device))


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device | str
                   ) -> dict[str, torch.Tensor]:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, 1, cfg.qk_rope_dim),
                                 dtype=dtype, device=device)}


def mla_prefill(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: dict[str, torch.Tensor], n_prefix: int = 0):
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    cache = {"ckv": _at_pos(cache["ckv"], c_kv, 0),
             "krope": _at_pos(cache["krope"], k_rope, 0)}
    o = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                    causal_mask(b, s, n_prefix, x.device))
    return o, cache


def mla_decode(p, cfg: ArchConfig, x: torch.Tensor,
               cache: dict[str, torch.Tensor], pos: int):
    """x (B, 1, D); attend over the latent cache[:, : pos + 1]."""
    b = x.shape[0]
    l = cache["ckv"].shape[1]
    positions = on_mesh(torch.full((b, 1), pos, dtype=torch.int64,
                                   device=x.device), x)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    ckv = _at_pos(cache["ckv"], c_kv, pos)
    krope = _at_pos(cache["krope"], k_rope, pos)
    mask = (torch.arange(l, device=x.device) <= pos).expand(b, 1, l)
    o = _mla_attend(p, cfg, q_nope, q_rope, ckv, krope, mask)
    return o, {"ckv": ckv, "krope": krope}
