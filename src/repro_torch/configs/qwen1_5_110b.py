"""Qwen1.5-110B: 80L d8192 64H GQA(kv=8) ff49152 vocab 152064, QKV bias.
[hf:Qwen/Qwen1.5-110B family]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, act="swiglu", qkv_bias=True, rope_theta=1e6,
    param_count=111e9,
)
