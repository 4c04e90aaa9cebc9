"""The language models of ``repro.models.transformer`` as an ``nn.Module``:
all ten assigned architectures.

The reference stacks each segment's layers on a leading axis and runs them
under ``jax.lax.scan``; here the layers are one ``nn.ModuleList`` in order,
walked by a Python loop, with the segment boundaries kept only where the
hybrid's shared block goes.  Block kinds: ``dense`` (MLA or GQA attention
and the gated MLP), ``moe`` (the same attention and ``models/moe.py``),
``mamba2`` and ``rwkv6`` (``models/ssm.py``).  A hybrid (zamba2) applies
its one ``shared`` dense block between segments, not after the last, with
a KV cache of its own per application.  Tied embeddings, the sqrt(d)
embedding scale and the ``vision_patches`` prefix stub are ported, and
so are the training loss and remat: under ``remat="full"`` each layer of
``layers`` runs through ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body), the hybrid's ``shared`` block not, as
it sits outside the reference's scan.

The sharding hook ``constrain(x, kind)`` is called where the reference
calls it: the embedding (``"activation"``), each attention, MLP, MoE and
Mamba2 output before it joins the residual stream (``"residual"``) and the
training forward's logits (``"logits"``).  The port also calls it on
RWKV6's two mixer outputs and on every residual addition of prefill and
decode, where the reference leaves the placement to GSPMD: DTensor would
carry the row-parallel product's pending sum through the norm into the
next product, and, weighing communication alone, gather that product's
weight and repeat it on every ``model`` rank.  With parameters made DTensors
(``distributed/shardings.distribute_model``) the model runs sharded over
their mesh; ``shardings.make_constrain`` gives the hook.  ``device="meta"``
builds the model without values (``common.MetaGenerator``).

Model API:
  Model(cfg, device=None, dtype=torch.bfloat16, generator=None, ...,
        constrain=None)
  forward(tokens, extra=None)          -> logits (B, S, padded vocab)
  forward_aux(tokens, extra=None)      -> (logits, {"lb_loss", "drop_frac"})
  loss(tokens, labels, extra=None)     -> (total, {"lb_loss", "drop_frac",
                                                   "ce"})
  init_cache(batch, max_len)           -> cache
  prefill(tokens, cache, extra=None)   -> (last-token logits, cache)
  decode(token, cache, pos)            -> (logits, cache)

The weights are made without gradients, so serving builds no graph; a
trainer turns them on (``model.requires_grad_(True)``).
"""
from __future__ import annotations

import torch
from torch import nn

from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from repro_torch.core.table import resolve_device
from . import attention as A
from . import ssm as S
from .common import (ArchConfig, MetaGenerator, dense_init, embed_lookup,
                     glu_act, on_mesh, rms_norm, softmax_cross_entropy,
                     whole_dim)
from .moe import init_moe, moe_forward

F32 = torch.float32


def _whole_batch_of_one(t: torch.Tensor) -> torch.Tensor:
    """A DTensor of batch 1 taken whole on its batch: the reference's
    specs cut even a batch of one over a data axis of one rank, and DTensor
    will not flatten a cut singleton dim into a product's rows."""
    return whole_dim(t, 0) if t.ndim and t.shape[0] == 1 else t


def segments(cfg: ArchConfig) -> list[tuple[str, int]]:
    """The config's runs of one block kind, (kind, layers), in order."""
    if cfg.family in ("dense", "audio", "vlm"):
        return [("dense", cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(("dense", cfg.first_dense_layers))
        segs.append(("moe", cfg.n_layers - cfg.first_dense_layers))
        return segs
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        segs, left = [], cfg.n_layers
        while left > 0:
            segs.append(("mamba2", min(k, left)))
            left -= k
        return segs
    if cfg.family == "ssm":
        return [("rwkv6", cfg.n_layers)]
    raise ValueError(cfg.family)


def _param(w: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(w, requires_grad=False)


def _zeros(n: int, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return _param(torch.zeros(n, dtype=dtype, device=device))


class GLU(nn.Module):
    """Gated MLP: ``act(x @ w_gate) * (x @ w_up) @ w_down``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        self.w_gate = _param(dense_init(gen, (d, f), dtype))
        self.w_up = _param(dense_init(gen, (d, f), dtype))
        self.w_down = _param(dense_init(gen, (f, d), dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu_act(x @ self.w_gate, x @ self.w_up, self.act) @ self.w_down


def _identity(x: torch.Tensor, kind: str) -> torch.Tensor:
    return x


class _Block(nn.Module):
    """A pre-norm block.  ``forward`` -> (x, (lb_loss, drop_frac) or None);
    ``step`` runs one layer of prefill or decode against its cache.
    ``constrain`` is the model's sharding hook (set by ``Model``)."""

    constrain = staticmethod(_identity)

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, scale, self.cfg.norm_eps, self.cfg.norms_f32)


class AttnBlock(_Block):
    """Kinds ``dense`` and ``moe``: MLA or GQA attention, then the gated MLP
    (dense) or the experts (moe), each added to the residual stream."""

    def __init__(self, kind: str, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype, padded_experts: int):
        super().__init__(cfg)
        self.kind = kind
        self.ln1 = _zeros(cfg.d_model, dtype, gen.device)
        self.attn = (A.init_mla if cfg.use_mla else A.init_gqa)(cfg, gen,
                                                                dtype)
        self.ln2 = _zeros(cfg.d_model, dtype, gen.device)
        if kind == "dense":
            self.mlp = GLU(cfg, gen, dtype)
        else:
            self.moe = init_moe(cfg, gen, dtype, padded_experts)

    def attend(self, x: torch.Tensor, positions: torch.Tensor,
               n_prefix: int, use_flash_kernel: bool) -> torch.Tensor:
        """The residual stream after the attention."""
        attn = A.mla_forward if self.cfg.use_mla else A.gqa_forward
        return x + self.constrain(
            attn(self.attn, self.cfg, self._norm(x, self.ln1), positions,
                 n_prefix, use_flash_kernel), "residual")

    def _ffn(self, x: torch.Tensor, capacity_factor: float):
        y = self._norm(x, self.ln2)
        if self.kind == "dense":
            return x + self.constrain(self.mlp(y), "residual"), None
        out, aux = moe_forward(self.moe, self.cfg, y,
                               self.moe["router"].shape[1], capacity_factor)
        return x + self.constrain(out, "residual"), \
            (aux["lb_loss"], aux["drop_frac"])

    def forward(self, x, positions, n_prefix, use_flash_kernel,
                capacity_factor):
        return self._ffn(self.attend(x, positions, n_prefix,
                                     use_flash_kernel), capacity_factor)

    def step(self, x, cache, pos, positions, n_prefix, decode,
             capacity_factor):
        y = self._norm(x, self.ln1)
        if self.cfg.use_mla:
            h, cache = (A.mla_decode(self.attn, self.cfg, y, cache, pos)
                        if decode else
                        A.mla_prefill(self.attn, self.cfg, y, positions,
                                      cache, n_prefix))
        else:
            h, cache = (A.gqa_decode(self.attn, self.cfg, y, cache, pos)
                        if decode else
                        A.gqa_prefill(self.attn, self.cfg, y, positions,
                                      cache, n_prefix))
        return self._ffn(x + self.constrain(h, "residual"),
                         capacity_factor)[0], cache

    def init_cache(self, batch, max_len, dtype, device):
        init = A.init_mla_cache if self.cfg.use_mla else A.init_kv_cache
        return init(self.cfg, batch, max_len, dtype, device)


class Mamba2Block(_Block):
    """Kind ``mamba2``: the Mamba2 mixer, added to the residual stream."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__(cfg)
        self.ln = _zeros(cfg.d_model, dtype, gen.device)
        self.mixer = S.init_mamba2(cfg, gen, dtype)

    def forward(self, x, positions, n_prefix, use_flash_kernel,
                capacity_factor):
        y, _ = S.mamba2_forward(self.mixer, self.cfg, self._norm(x, self.ln))
        return x + self.constrain(y, "residual"), None

    def step(self, x, cache, pos, positions, n_prefix, decode,
             capacity_factor):
        y = self._norm(x, self.ln)
        y, state = (S.mamba2_decode(self.mixer, self.cfg, y, cache) if decode
                    else S.mamba2_forward(self.mixer, self.cfg, y,
                                          conv_state=cache[0],
                                          ssm_state=cache[1]))
        return x + self.constrain(y, "residual"), state

    def init_cache(self, batch, max_len, dtype, device):
        return S.init_mamba2_state(self.cfg, batch, dtype, device)


class RWKV6Block(_Block):
    """Kind ``rwkv6``: the time mix, then the channel mix, each added to
    the residual stream."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__(cfg)
        self.ln1 = _zeros(cfg.d_model, dtype, gen.device)
        self.tm = S.init_rwkv6(cfg, gen, dtype)
        self.ln2 = _zeros(cfg.d_model, dtype, gen.device)
        self.ffn = S.init_rwkv_ffn(cfg, gen, dtype)

    def step(self, x, cache, pos, positions, n_prefix, decode,
             capacity_factor):
        """``cache`` is (the time mix's (x_prev, wkv), the channel mix's
        x_prev); ``None`` starts from zeros."""
        tm_state, ffn_prev = cache if cache is not None else (None, None)
        y = self._norm(x, self.ln1)
        y, tm_state = (S.rwkv6_decode(self.tm, self.cfg, y, tm_state)
                       if decode else
                       S.rwkv6_forward(self.tm, self.cfg, y, state=tm_state))
        x = x + self.constrain(y, "residual")
        y, ffn_prev = S.rwkv_ffn_forward(self.ffn, self.cfg,
                                         self._norm(x, self.ln2),
                                         x_prev=ffn_prev)
        return x + self.constrain(y, "residual"), (tm_state, ffn_prev)

    def forward(self, x, positions, n_prefix, use_flash_kernel,
                capacity_factor):
        return self.step(x, None, 0, positions, n_prefix, False,
                         capacity_factor)[0], None

    def init_cache(self, batch, max_len, dtype, device):
        return (S.init_rwkv6_state(self.cfg, batch, dtype, device),
                torch.zeros((batch, self.cfg.d_model), dtype=dtype,
                            device=device))


def _block(kind: str, cfg: ArchConfig, gen: torch.Generator,
           dtype: torch.dtype, padded_experts: int) -> _Block:
    if kind in ("dense", "moe"):
        return AttnBlock(kind, cfg, gen, dtype, padded_experts)
    if kind == "mamba2":
        return Mamba2Block(cfg, gen, dtype)
    if kind == "rwkv6":
        return RWKV6Block(cfg, gen, dtype)
    raise ValueError(kind)


class Model(nn.Module):
    """A language model of any of the ten families with random weights from
    ``generator`` (seed 0 on the model's device when None).  ``device`` is
    ``cuda`` unless the caller names another; without CUDA that raises.
    ``expert_pad`` pads the expert count to a multiple (the padding
    experts are masked out of the routing) and ``capacity_factor`` sizes
    the experts' capacity, and ``remat`` (``"none"`` or ``"full"``)
    recomputes each layer in the backward pass, as the reference's
    arguments of those names.  Parameters the reference creates in float32
    (the SSMs' decays and skips) stay float32 in a bf16 model.
    ``constrain`` is the sharding hook (identity when None); on
    ``device="meta"`` the model has shapes only."""

    def __init__(self, cfg: ArchConfig, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 vocab_pad: int = 1, use_flash_kernel: bool = False,
                 expert_pad: int = 16, capacity_factor: float = 1.25,
                 remat: str = "none", constrain=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = MetaGenerator() if dev.type == "meta" else \
                torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        if remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
        self.cfg = cfg
        self.remat = remat
        self.vocab_pad = vocab_pad
        self.expert_pad = expert_pad
        self.use_flash_kernel = use_flash_kernel
        self.capacity_factor = capacity_factor
        gen = generator
        self.embed = _param(dense_init(gen, (self.padded_vocab, cfg.d_model),
                                       dtype, scale=0.02))
        self.final_norm = _zeros(cfg.d_model, dtype, dev)
        self.lm_head = None if cfg.tie_embeddings else _param(
            dense_init(gen, (cfg.d_model, self.padded_vocab), dtype))
        segs = segments(cfg)
        self.layers = nn.ModuleList(
            _block(kind, cfg, gen, dtype, self.padded_experts)
            for kind, count in segs for _ in range(count))
        # the shared block follows each segment but the last
        ends = [sum(c for _, c in segs[:i + 1]) - 1 for i in range(len(segs))]
        self.shared_after = tuple(ends[:-1]) if cfg.shared_attn_every else ()
        self.shared = _block("dense", cfg, gen, dtype, 0) \
            if cfg.shared_attn_every else None
        self.constrain = constrain or _identity
        for block in (*self.layers, self.shared):
            if block is not None:
                block.constrain = self.constrain

    # -- helpers -------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def padded_experts(self) -> int:
        e, m = self.cfg.n_experts, self.expert_pad
        return (e + m - 1) // m * m if e else 0

    @property
    def padded_vocab(self) -> int:
        v, m = self.cfg.vocab, self.vocab_pad
        return (v + m - 1) // m * m

    def _mask_vocab_pad(self, logits: torch.Tensor) -> torch.Tensor:
        if self.padded_vocab == self.cfg.vocab:
            return logits
        iota = torch.arange(self.padded_vocab, device=logits.device)
        return logits.masked_fill(on_mesh(iota >= self.cfg.vocab, logits),
                                  -1e30)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps, self.cfg.norms_f32)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return self._mask_vocab_pad(x @ head)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(_whole_batch_of_one(tokens.to(self.device)),
                         self.embed)
        if self.cfg.embed_scale:       # the scale rounded to x's dtype first
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _embed(self, tokens: torch.Tensor, extra: dict | None = None):
        """Token embeddings, behind the patch prefix of a vision config."""
        x = self._embed_tokens(tokens)
        n_prefix = 0
        if self.cfg.frontend == "vision_patches":
            patches = on_mesh(extra["patches"].to(device=x.device,
                                                  dtype=x.dtype), x)
            x = torch.cat([patches, x], dim=1)        # stub frontend
            n_prefix = patches.shape[1]
        return self.constrain(x, "activation"), n_prefix

    @staticmethod
    def _positions(b: int, s: int, x: torch.Tensor) -> torch.Tensor:
        return on_mesh(torch.arange(s, device=x.device).expand(b, s), x)

    # -- forward -------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, extra: dict | None = None
                ) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S + prefix, padded vocab)."""
        return self.forward_aux(tokens, extra)[0]

    def forward_aux(self, tokens: torch.Tensor, extra: dict | None = None):
        """-> (logits, {"lb_loss", "drop_frac"}): the MoE layers' load
        balancing loss and drop fraction summed over the layers (float32
        zeros where there are none)."""
        x, n_prefix = self._embed(tokens, extra)
        b, s, _ = x.shape
        positions = self._positions(b, s, x)
        lb = torch.zeros((), dtype=F32, device=x.device)
        drop = torch.zeros((), dtype=F32, device=x.device)
        args = (positions, n_prefix, self.use_flash_kernel,
                self.capacity_factor)
        remat = self.remat == "full" and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, aux = checkpoint(layer, x, *args, use_reentrant=False)
            else:
                x, aux = layer(x, *args)
            if aux is not None:
                lb, drop = lb + aux[0], drop + aux[1]
            if i in self.shared_after:
                x, _ = self.shared(x, *args)
        return self.constrain(self._head(x), "logits"), \
            {"lb_loss": lb, "drop_frac": drop}

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             extra: dict | None = None):
        """Next-token cross-entropy -> (total, aux): the logits past the
        vision prefix at positions :-1 against ``labels`` at 1:, plus 0.01
        of the load-balancing loss; ``aux`` is ``forward_aux``'s with
        ``"ce"`` added."""
        logits, aux = self.forward_aux(tokens, extra)
        n_prefix = logits.shape[1] - labels.shape[1]
        if n_prefix:
            logits = logits[:, n_prefix:]
        ce = softmax_cross_entropy(logits[:, :-1],
                                   labels[:, 1:].to(logits.device))
        aux["ce"] = ce
        return ce + 0.01 * aux["lb_loss"], aux

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> dict[str, list]:
        """{"layers": one cache a layer, "shared": one a shared-block
        application}; ``dtype`` (the model's by default) is that of the KV
        caches and token shifts, the SSM states are float32."""
        dt, dev = dtype or self.dtype, self.device
        return {"layers": [layer.init_cache(batch, max_len, dt, dev)
                           for layer in self.layers],
                "shared": [self.shared.init_cache(batch, max_len, dt, dev)
                           for _ in self.shared_after]}

    def _with_cache(self, x, cache, pos, positions, n_prefix, decode):
        cache = tree_map(_whole_batch_of_one, cache)
        new = {"layers": [], "shared": []}
        shared = iter(cache["shared"])
        for i, layer in enumerate(self.layers):
            x, c = layer.step(x, cache["layers"][i], pos, positions,
                              n_prefix, decode, self.capacity_factor)
            new["layers"].append(c)
            if i in self.shared_after:
                x, c = self.shared.step(x, next(shared), pos, positions,
                                        n_prefix, decode,
                                        self.capacity_factor)
                new["shared"].append(c)
        return x, new

    def prefill(self, tokens: torch.Tensor, cache: dict,
                extra: dict | None = None):
        """Run the prompt, fill the cache -> (logits (B, 1, V), cache)."""
        x, n_prefix = self._embed(tokens, extra)
        b, s, _ = x.shape
        x, cache = self._with_cache(x, cache, 0, self._positions(b, s, x),
                                    n_prefix, decode=False)
        return self._head(x[:, -1:]), cache

    def decode(self, token: torch.Tensor, cache: dict, pos: int):
        """token (B, 1) at position ``pos`` -> (logits (B, 1, V), cache)."""
        x = self._embed_tokens(token)
        x, cache = self._with_cache(x, cache, pos, None, 0, decode=True)
        return self._head(x), cache
