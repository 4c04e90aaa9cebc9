"""Gemma-7B: 28L d3072 16H (kv=16) head_dim=256 ff24576 vocab 256000,
GeGLU, tied embeddings, sqrt(d) embed scale.  [arXiv:2403.08295]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="geglu", rope_theta=1e4,
    tie_embeddings=True, embed_scale=True,
    param_count=8.5e9,
)
