"""MusicGen-large backbone: 48L d2048 32H (kv=32) ff8192 over EnCodec token
vocab 2048.  The EnCodec frontend is a STUB: inputs are codec token ids
(the modality frontend would produce them offline).  [arXiv:2306.05284]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="swiglu", rope_theta=1e4,
    frontend="audio_frames",
    param_count=3.3e9,
)
