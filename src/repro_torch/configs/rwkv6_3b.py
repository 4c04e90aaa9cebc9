"""RWKV6 (Finch) 3B: 32L d2560 attention-free (data-dependent decay),
channel-mix ff8960, vocab 65536.  [arXiv:2404.05892]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, act="swiglu", rope_theta=1e4,
    sub_quadratic=True,
    param_count=3.1e9,
)
