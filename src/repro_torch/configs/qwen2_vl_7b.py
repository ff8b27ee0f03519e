"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (t/h/w sections 16/24/24 of head_dim/2=64), QKV bias;
vision tower STUBBED: the caller provides 256 precomputed patch embeddings
merged at the sequence front. [arXiv:2409.12191; hf]
(Port of ``repro.configs.qwen2_vl_7b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, qkv_bias=True, mrope_sections=(16, 24, 24),
    rope_theta=1000000.0, img_tokens=256,
))
