"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
— RoPE (partial 0.5), QKV bias. [hf:THUDM/glm-4-9b; hf]
(Port of ``repro.configs.glm4_9b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, qkv_bias=True, rotary_frac=0.5, rope_theta=10000.0,
))
