"""IBM Granite-3.0 MoE 3B-A800M: 32L d1536 24H GQA(kv=8), MoE 40 experts
top-8, expert ff512, vocab 49155.  [hf:ibm-granite/granite-3.0-3b-a800m]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, act="swiglu", rope_theta=1e4,
    n_experts=40, top_k=8, d_ff_expert=512,
    param_count=3.3e9, active_param_count=0.8e9,
)
