"""Sub-quadratic mixers of ``repro.models.ssm``: Mamba2 (the zamba2 hybrid)
and RWKV6 "Finch".

Both are O(S) in sequence length with an O(1) decode state.  The
reference runs the recurrence under ``jax.lax.scan`` over time; here it is
a Python loop over the time steps in plain PyTorch (:func:`scan`; the
reference has no
Pallas kernel for it, so the port owes no CUDA kernel).  Decode is the same
forward on one token from the carried state.

The decay and skip parameters (``a_log``, ``dt_bias``, ``d_skip``, ``w0``,
``u``, ``ln_scale``) are float32 whatever the model's dtype, and so are the
recurrent states, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate

from .common import (ArchConfig, cut_dims, cut_over, dense_init, merge_dim,
                     on_mesh, on_shards, param_dict, placed_as, split_dim,
                     whole_dim)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _m2_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(d_inner, heads, head dim 64)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = 64
    return d_inner, d_inner // hd, hd


def init_mamba2(cfg: ArchConfig, gen: torch.Generator,
                dtype: torch.dtype) -> nn.ParameterDict:
    d = cfg.d_model
    d_inner, heads, _ = _m2_dims(cfg)
    n = cfg.ssm_state
    conv_ch = d_inner + 2 * n
    dev = gen.device
    return param_dict({
        "w_in": dense_init(gen, (d, 2 * d_inner + 2 * n + heads), dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype, scale=0.5),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "a_log": torch.zeros(heads, dtype=F32, device=dev),
        "dt_bias": torch.zeros(heads, dtype=F32, device=dev),
        "d_skip": torch.ones(heads, dtype=F32, device=dev),
        "w_out": dense_init(gen, (d_inner, d), dtype)})


def scan(step, carry, n: int):
    """``carry, y_i = step(i, carry)`` for i in 0..n-1 -> (the last carry,
    [y_0, ..., y_{n-1}]): a time loop, as the reference's ``lax.scan``."""
    ys = []
    for i in range(n):
        carry, y = step(i, carry)
        ys.append(y)
    return carry, ys


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: torch.Tensor | None = None):
    """x (B, S, C); w (K, C) depthwise causal; state (B, K-1, C) carry-in.
    -> (silu(conv + b), the last K-1 inputs as the next state)."""
    k = w.shape[0]
    if state is None:
        pad = on_mesh(torch.zeros((x.shape[0], k - 1, x.shape[2]),
                                  dtype=x.dtype, device=x.device), x)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):                       # the reference's order
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b), xp[:, -(k - 1):].clone()


def _m2_split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """The input projection -> (z, xbc, dt)."""
    d_inner, heads, _ = _m2_dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt = zxbcdt[..., -heads:]
    return z, xbc, dt


def mamba2_forward(p, cfg: ArchConfig, x: torch.Tensor,
                   conv_state: torch.Tensor | None = None,
                   ssm_state: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), (conv_state, ssm_state)); the SSM
    state (B, H, hd, N) float32 runs ``h' = decay h + dt x (x) b`` and
    ``y = h c`` one time step at a time.

    On a mesh the projection's width is cut evenly, across the boundaries
    of z, x, (B, C) and dt: it is gathered once, and z, x (its heads) and
    dt are cut again, locally, over the same mesh dims, while B and C,
    which every head reads, stay whole.  The depthwise convolution runs on
    x's channels and on (B, C)'s apart, each against its own rows of the
    kernel, so every rank works on its own heads only."""
    b, s, _ = x.shape
    d_inner, heads, hd = _m2_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x @ p["w_in"]
    cut = cut_dims(zxbcdt, 2)
    z, xbc, dt = _m2_split(cfg, whole_dim(zxbcdt, 2))
    z, dt = cut_over(z, 2, cut), cut_over(dt, 2, cut)
    cw, cb = whole_dim(p["conv_w"], 1), whole_dim(p["conv_b"], 0)
    st = (None, None) if conv_state is None else \
        (cut_over(conv_state[..., :d_inner], 2, cut),
         conv_state[..., d_inner:])
    xs, xs_state = _causal_depthwise_conv(
        cut_over(xbc[..., :d_inner], 2, cut), cut_over(cw[:, :d_inner], 1,
                                                       cut),
        cut_over(cb[:d_inner], 0, cut), st[0])
    bc, bc_state = _causal_depthwise_conv(xbc[..., d_inner:],
                                          cw[:, d_inner:], cb[d_inner:],
                                          st[1])
    conv_out = torch.cat([whole_dim(xs_state, 2), bc_state], dim=-1)
    xs = split_dim(xs, 2, heads)                             # (B,S,H,hd)
    bmat = bc[..., :n].float()                               # (B,S,N)
    cmat = bc[..., n:].float()                               # (B,S,N)
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B,S,H)
    a = -torch.exp(p["a_log"])                               # (H,)
    decay = torch.exp(dt * a)                                # (B,S,H)
    dtx = dt[..., None] * xs.float()                         # (B,S,H,hd)

    h = ssm_state if ssm_state is not None else \
        on_mesh(torch.zeros((b, heads, hd, n), dtype=F32, device=x.device), x)
    decay, dtx, bmat, cmat = (whole_dim(t, 1) for t in (decay, dtx, bmat,
                                                        cmat))
    # the state placed as the step's products, so DTensor moves none of
    # them; mesh dims that cut neither its batch nor its heads (batch-1
    # decode) cut its head dim, as the reference's plan cuts it
    h = placed_as(h, dtx[:, 0, :, :, None])
    idle = [i for i, q in enumerate(getattr(h, "placements", ()))
            if isinstance(q, Replicate)]
    h, dtx = cut_over(h, 2, idle), cut_over(dtx, 3, idle)

    def step(i, h):
        h = h * decay[:, i, :, None, None] + \
            dtx[:, i, :, :, None] * bmat[:, i, None, None, :]
        return h, on_shards(_read_state, (0, 1, 2), (h, 0, 1, 2),
                            (cmat[:, i], 0, None))

    h, ys = scan(step, h, s)
    y = torch.stack(ys, dim=1)                               # (B,S,H,hd)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = (merge_dim(y, 2) * F.silu(z.float())).to(x.dtype)
    return y @ p["w_out"], (conv_out, h)


def _read_state(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y_t = h_t c_t: (B,H,hd,N) x (B,N) -> (B,H,hd)."""
    return torch.einsum("bhdn,bn->bhd", h, c)


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                      device: torch.device | str):
    """(conv state (B, K-1, C) in ``dtype``, SSM state (B, H, hd, N)
    float32)."""
    d_inner, heads, hd = _m2_dims(cfg)
    conv_ch = d_inner + 2 * cfg.ssm_state
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                        device=device),
            torch.zeros((batch, heads, hd, cfg.ssm_state), dtype=F32,
                        device=device))


def mamba2_decode(p, cfg: ArchConfig, x: torch.Tensor, state):
    """x (B, 1, D); state from :func:`init_mamba2_state`; O(1) a token."""
    return mamba2_forward(p, cfg, x, conv_state=state[0],
                          ssm_state=state[1])


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay
# ---------------------------------------------------------------------------

_RWKV_HD = 64


def init_rwkv6(cfg: ArchConfig, gen: torch.Generator,
               dtype: torch.dtype) -> nn.ParameterDict:
    d = cfg.d_model
    heads = d // _RWKV_HD
    lora = 64
    dev = gen.device
    z = lambda: torch.zeros(d, dtype=dtype, device=dev)
    return param_dict({
        # token-shift mixing coefficients per stream
        "mu_r": z(), "mu_k": z(), "mu_v": z(), "mu_w": z(), "mu_g": z(),
        "wr": dense_init(gen, (d, d), dtype),
        "wk": dense_init(gen, (d, d), dtype),
        "wv": dense_init(gen, (d, d), dtype),
        "wg": dense_init(gen, (d, d), dtype),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -5.0, dtype=F32, device=dev),
        "w_a": dense_init(gen, (d, lora), dtype),
        "w_b": dense_init(gen, (lora, d), dtype, scale=0.02),
        "u": torch.zeros((heads, _RWKV_HD), dtype=F32, device=dev),
        "ln_scale": torch.ones(d, dtype=F32, device=dev),
        "wo": dense_init(gen, (d, d), dtype)})


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Each token's predecessor: ``x_prev`` (B, D) before the first."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_streams(p, x: torch.Tensor, x_prev: torch.Tensor):
    """Token shift: mix the current and previous token per channel into the
    r, k, v, g streams and the decay w (float32); also the last token."""
    shifted = _shift(x, x_prev)

    def mix(mu):
        return x + (shifted - x) * mu

    # wr has no sharding rule (replicated, as the reference's); cut as wk,
    # each rank computes its own heads' r, as XLA partitions that product
    r = mix(p["mu_r"]) @ placed_as(p["wr"], p["wk"])
    k = mix(p["mu_k"]) @ p["wk"]
    v = mix(p["mu_v"]) @ p["wv"]
    g = mix(p["mu_g"]) @ p["wg"]
    wx = mix(p["mu_w"])
    w = torch.exp(-torch.exp(p["w0"] +
                             (torch.tanh(wx @ p["w_a"]) @ p["w_b"]).float()))
    return r, k, v, g, w, x[:, -1].clone()


def rwkv6_forward(p, cfg: ArchConfig, x: torch.Tensor, state=None):
    """x (B, S, D) -> (y (B, S, D), (x_last (B, D), wkv (B, H, hd, hd)
    float32)); ``state`` is the carried (x_prev, wkv)."""
    b, s, d = x.shape
    heads, hd = d // _RWKV_HD, _RWKV_HD
    if state is None:
        x_prev = on_mesh(torch.zeros((b, d), dtype=x.dtype, device=x.device),
                         x)
        wkv = on_mesh(torch.zeros((b, heads, hd, hd), dtype=F32,
                                  device=x.device), x)
    else:
        x_prev, wkv = state
    r, k, v, g, w, x_last = _rwkv_streams(p, x, x_prev)
    rh = split_dim(r, 2, heads).float()                      # (B,S,H,hd)
    kh = split_dim(k, 2, heads).float()
    vh = split_dim(v, 2, heads).float()
    wh = split_dim(w, 2, heads)
    u = p["u"][None, :, :, None]
    # the streams cut on their batch where the carried state is (a decode
    # cache: a reduce-scatter of the products' pending sums), any other
    # pending sum reduced (DTensor would reduce-scatter a batch of one onto
    # ranks that hold none of it), and the state then placed as the step's
    # products, so DTensor moves none of them
    rh, kh, vh, wh = (placed_as(t, t) for t in (
        cut_over(whole_dim(t, 1), 0, cut_dims(wkv, 0))
        for t in (rh, kh, vh, wh)))
    wkv = placed_as(wkv, kh[:, 0, :, :, None])

    def step(i, wkv):
        kv = kh[:, i, :, :, None] * vh[:, i, :, None, :]        # (B,H,hd,hd)
        y = on_shards(_read_wkv, (0, 1), (rh[:, i], 0, 1),
                      (wkv + u * kv, 0, 1))
        return wh[:, i, :, :, None] * wkv + kv, y

    wkv, ys = scan(step, wkv, s)
    y = torch.stack(ys, dim=1)                               # (B,S,H,hd)
    # group norm per head (population variance, as jnp.var), then the gate
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = merge_dim((y - mean) * torch.rsqrt(var + 1e-5), 2) * \
        p["ln_scale"]
    y = (y * F.silu(g.float())).to(x.dtype)
    return y @ p["wo"], (x_last, wkv)


def _read_wkv(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y_t = r_t (wkv + u k_t v_t): (B,H,hd) x (B,H,hd,hd) -> (B,H,hd)."""
    return torch.einsum("bhk,bhkv->bhv", r, s)


def init_rwkv_ffn(cfg: ArchConfig, gen: torch.Generator,
                  dtype: torch.dtype) -> nn.ParameterDict:
    """The channel mix; its names (fk/fv/fr) differ from the time mix's, as
    in the reference."""
    d, f = cfg.d_model, cfg.d_ff
    z = lambda: torch.zeros(d, dtype=dtype, device=gen.device)
    return param_dict({"mu_k": z(), "mu_r": z(),
                    "fk": dense_init(gen, (d, f), dtype),
                    "fv": dense_init(gen, (f, d), dtype),
                    "fr": dense_init(gen, (d, d), dtype)})


def rwkv_ffn_forward(p, cfg: ArchConfig, x: torch.Tensor,
                     x_prev: torch.Tensor | None = None):
    """RWKV channel mix: a squared-ReLU FFN with token shift -> (y, the
    last token)."""
    b, _, d = x.shape
    if x_prev is None:
        x_prev = on_mesh(torch.zeros((b, d), dtype=x.dtype, device=x.device),
                         x)
    shifted = _shift(x, x_prev)
    xk = x + (shifted - x) * p["mu_k"]
    xr = x + (shifted - x) * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["fk"]))
    return torch.sigmoid(xr @ p["fr"]) * (k @ p["fv"]), x[:, -1].clone()


def init_rwkv6_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device | str):
    """(x_prev (B, D) in ``dtype``, wkv (B, H, hd, hd) float32)."""
    d = cfg.d_model
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, d // _RWKV_HD, _RWKV_HD, _RWKV_HD),
                        dtype=F32, device=device))


def rwkv6_decode(p, cfg: ArchConfig, x: torch.Tensor, state):
    """x (B, 1, D); state from :func:`init_rwkv6_state`; O(1) a token."""
    return rwkv6_forward(p, cfg, x, state)
