"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 — per-head QK-norm, partial rotary (StableLM-2-12B family).
[hf:stabilityai/stablelm-2-1_6b scaled; hf]
(Port of ``repro.configs.stablelm_12b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, qk_norm=True, rotary_frac=0.25, rope_theta=10000.0,
    norm="layernorm", act="swiglu",
))
