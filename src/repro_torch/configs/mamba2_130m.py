"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), chunked dual form; d_ff=0
(no MLP block). [arXiv:2405.21060]
(Port of ``repro.configs.mamba2_130m``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True, use_rope=False,
))
