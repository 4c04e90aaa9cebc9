"""DeepSeek-V2 236B: 60L d5120 128H MLA(kv_lora=512, q_lora=1536,
qk_nope=128 qk_rope=64 v=128), MoE 160 routed top-6 + 2 shared,
expert ff1536, first layer dense, vocab 102400.  [arXiv:2405.04434]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400, act="swiglu", rope_theta=1e4,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    first_dense_layers=1,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    param_count=236e9, active_param_count=21e9,
)
