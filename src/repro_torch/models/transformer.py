"""The dense-GQA language model of ``repro.models.transformer`` as an
``nn.Module``.

The reference stacks each segment's layers on a leading axis and runs them
under ``jax.lax.scan``; here the layers are an ``nn.ModuleList`` walked by a
Python loop.  Ported: the families whose layers are all the dense block
(``dense``, ``audio``, ``vlm``: one ``("dense", L)`` segment), tied
embeddings, the sqrt(d) embedding scale and the ``vision_patches`` prefix
stub.  ``moe``, ``hybrid``, ``ssm`` and MLA raise ``NotImplementedError``
(ROADMAP A11), as do training (``loss``, remat) and the sharding hook.

Model API:
  Model(cfg, device=None, dtype=torch.bfloat16, generator=None, ...)
  forward(tokens, extra=None)          -> logits (B, S, padded vocab)
  init_cache(batch, max_len)           -> cache
  prefill(tokens, cache, extra=None)   -> (last-token logits, cache)
  decode(token, cache, pos)            -> (logits, cache)

The weights hold no gradients: training is a later slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.table import resolve_device
from . import attention as A
from .common import ArchConfig, dense_init, glu_act, rms_norm

DENSE_FAMILIES = ("dense", "audio", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a family or attention variant the port does not have yet."""
    if cfg.family not in DENSE_FAMILIES or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with MLA' if cfg.use_mla else ''} is not ported yet; the "
            f"port runs the dense-GQA families {DENSE_FAMILIES} (ROADMAP A11)")


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


class DenseBlock(nn.Module):
    """Pre-norm block: GQA attention, then the gated MLP, each added to the
    residual stream."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _zeros(cfg.d_model, dtype, gen.device)
        self.attn = A.init_gqa(cfg, gen, dtype)
        self.ln2 = _zeros(cfg.d_model, dtype, gen.device)
        self.mlp = GLU(cfg, gen, dtype)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, scale, self.cfg.norm_eps, self.cfg.norms_f32)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                n_prefix: int, use_flash_kernel: bool) -> torch.Tensor:
        x = x + A.gqa_forward(self.attn, self.cfg, self._norm(x, self.ln1),
                              positions, n_prefix, use_flash_kernel)
        return x + self.mlp(self._norm(x, self.ln2))

    def step(self, x: torch.Tensor, cache: dict, pos: int,
             positions: torch.Tensor | None, n_prefix: int, decode: bool):
        """One layer of prefill or decode against its cache."""
        y = self._norm(x, self.ln1)
        if decode:
            h, cache = A.gqa_decode(self.attn, self.cfg, y, cache, pos)
        else:
            h, cache = A.gqa_prefill(self.attn, self.cfg, y, positions, cache,
                                     n_prefix)
        x = x + h
        return x + self.mlp(self._norm(x, self.ln2)), cache


class Model(nn.Module):
    """A dense-GQA language model with random weights from ``generator``
    (seed 0 on the model's device when None).  ``device`` is ``cuda`` unless
    the caller names another; without CUDA that raises."""

    def __init__(self, cfg: ArchConfig, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 vocab_pad: int = 1, use_flash_kernel: bool = False):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        self.cfg = cfg
        self.vocab_pad = vocab_pad
        self.use_flash_kernel = use_flash_kernel
        gen = generator
        self.embed = _param(dense_init(gen, (self.padded_vocab, cfg.d_model),
                                       dtype, scale=0.02))
        self.final_norm = _zeros(cfg.d_model, dtype, dev)
        self.lm_head = None if cfg.tie_embeddings else _param(
            dense_init(gen, (cfg.d_model, self.padded_vocab), dtype))
        self.layers = nn.ModuleList(DenseBlock(cfg, gen, dtype)
                                    for _ in range(cfg.n_layers))

    # -- helpers -------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def padded_vocab(self) -> int:
        v, m = self.cfg.vocab, self.vocab_pad
        return (v + m - 1) // m * m

    def _mask_vocab_pad(self, logits: torch.Tensor) -> torch.Tensor:
        if self.padded_vocab == self.cfg.vocab:
            return logits
        iota = torch.arange(self.padded_vocab, device=logits.device)
        return logits.masked_fill(iota >= self.cfg.vocab, -1e30)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps, self.cfg.norms_f32)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return self._mask_vocab_pad(x @ head)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.to(self.device)]
        if self.cfg.embed_scale:       # the scale rounded to x's dtype first
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _embed(self, tokens: torch.Tensor, extra: dict | None = None):
        """Token embeddings, behind the patch prefix of a vision config."""
        x = self._embed_tokens(tokens)
        n_prefix = 0
        if self.cfg.frontend == "vision_patches":
            patches = extra["patches"].to(device=x.device, dtype=x.dtype)
            x = torch.cat([patches, x], dim=1)        # stub frontend
            n_prefix = patches.shape[1]
        return x, n_prefix

    @staticmethod
    def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
        return torch.arange(s, device=device).expand(b, s)

    # -- forward -------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, extra: dict | None = None
                ) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S + prefix, padded vocab)."""
        x, n_prefix = self._embed(tokens, extra)
        b, s, _ = x.shape
        positions = self._positions(b, s, x.device)
        for layer in self.layers:
            x = layer(x, positions, n_prefix, self.use_flash_kernel)
        return self._head(x)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> list[dict]:
        return [A.init_kv_cache(self.cfg, batch, max_len, dtype or self.dtype,
                                self.device) for _ in self.layers]

    def _with_cache(self, x, cache, pos, positions, n_prefix, decode):
        new_cache = []
        for layer, layer_cache in zip(self.layers, cache):
            x, c = layer.step(x, layer_cache, pos, positions, n_prefix, decode)
            new_cache.append(c)
        return x, new_cache

    def prefill(self, tokens: torch.Tensor, cache: list[dict],
                extra: dict | None = None):
        """Run the prompt, fill the cache -> (logits (B, 1, V), cache)."""
        x, n_prefix = self._embed(tokens, extra)
        b, s, _ = x.shape
        x, cache = self._with_cache(x, cache, 0, self._positions(b, s, x.device),
                                    n_prefix, decode=False)
        return self._head(x[:, -1:]), cache

    def decode(self, token: torch.Tensor, cache: list[dict], pos: int):
        """token (B, 1) at position ``pos`` -> (logits (B, 1, V), cache)."""
        x = self._embed_tokens(token)
        x, cache = self._with_cache(x, cache, pos, None, 0, decode=True)
        return self._head(x), cache
