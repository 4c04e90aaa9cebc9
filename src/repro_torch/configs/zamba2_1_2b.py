"""Zamba2-1.2B: 38 Mamba2 blocks (d2048, state 64, expand 2) with a shared
attention+MLP block (32H, ff8192) applied every 6 layers, vocab 32000.
[arXiv:2411.15242]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, act="swiglu", rope_theta=1e4,
    ssm_state=64, ssm_expand=2, ssm_conv=4, shared_attn_every=6,
    sub_quadratic=True,
    param_count=1.2e9,
)
