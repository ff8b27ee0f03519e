"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768,
128 experts top-8, QK-norm per head, no shared expert, vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]
(Port of ``repro.configs.qwen3_moe_30b_a3b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=0,
    head_dim=128, vocab=151936, n_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1000000.0, moe_norm_topk=True,
))
