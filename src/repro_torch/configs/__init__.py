"""Assigned architectures (exact public configs) and input-shape sets, copied
from ``repro.configs``.

``iter_cells()`` enumerates every (arch x shape) cell; pure full-attention
archs skip long_500k.  ``input_specs`` gives the inputs of a cell as
``meta`` tensors (the reference's ``ShapeDtypeStruct`` stand-ins), which
the LM dry-run (``launch/dryrun.py``) shards and runs on.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.models.common import ArchConfig

ARCH_IDS = [
    "mistral_nemo_12b", "phi3_mini_3_8b", "qwen1_5_110b", "gemma_7b",
    "deepseek_v2_236b", "granite_moe_3b_a800m", "zamba2_1_2b",
    "musicgen_large", "paligemma_3b", "rwkv6_3b",
]

# shape_id -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def input_specs(cfg: ArchConfig, shape_id: str, reduced: bool = False
                ) -> dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a cell, with
    the reference's shapes and dtypes (int32 tokens, float32 patches).

    No allocation: the dry-run runs against these.  ``reduced`` scales the
    shapes down for smoke use."""
    seq, batch, kind = SHAPES[shape_id]
    if reduced:
        seq, batch = min(seq, 128), min(batch, 2)

    def f(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        spec = {"tokens": f((batch, seq)), "labels": f((batch, seq))}
    elif kind == "prefill":
        spec = {"tokens": f((batch, seq))}
    else:  # decode: one new token against a seq-long cache
        spec = {"token": f((batch, 1))}
    if cfg.frontend == "vision_patches" and kind != "decode":
        spec["patches"] = f((batch, cfg.n_prefix, cfg.d_model), torch.float32)
    return spec


def cell_enabled(cfg: ArchConfig, shape_id: str) -> tuple[bool, str]:
    if shape_id == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524k decode skipped (DESIGN.md §5)"
    return True, ""


def iter_cells():
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_id in SHAPES:
            ok, why = cell_enabled(cfg, shape_id)
            yield arch_id, shape_id, ok, why
