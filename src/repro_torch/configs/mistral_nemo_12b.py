"""Mistral-Nemo-Base-2407: 40L d5120 32H GQA(kv=8) head_dim=128 ff14336
vocab 131072, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, act="swiglu", rope_theta=1e6,
    param_count=12.2e9,
)
