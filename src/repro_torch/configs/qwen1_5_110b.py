"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias. bf16 params + bf16 AdamW moments so the 110B
footprint fits 256 chips. [hf:Qwen/Qwen1.5-0.5B scaled; hf]
(Port of ``repro.configs.qwen1_5_110b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab=152064, qkv_bias=True, rope_theta=1000000.0,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
))
