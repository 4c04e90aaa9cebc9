"""PaliGemma-3B language backbone: 18L d2048 8H MQA(kv=1) ff16384
vocab 257216; SigLIP vision frontend is a STUB (input_specs supplies 256
precomputed patch embeddings), prefix-LM attention over the patch prefix.
[arXiv:2407.07726]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, act="geglu", rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
    frontend="vision_patches", n_prefix=256, prefix_lm=True,
    param_count=2.9e9,
)
