"""Assigned architectures (exact public configs) and input-shape sets, copied
from ``repro.configs``.

``iter_cells()`` enumerates every (arch x shape) cell; pure full-attention
archs skip long_500k.  The reference's ``input_specs`` builds JAX shape
stand-ins for its dry-run and comes with the LM dry-run (ROADMAP queue A,
item 1).
"""
from __future__ import annotations

import importlib

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
