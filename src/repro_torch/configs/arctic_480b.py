"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + DENSE residual MLP in parallel (dense-MoE hybrid).
bf16 params+moments to fit. [hf:Snowflake/snowflake-arctic-base; hf]
(Port of ``repro.configs.arctic_480b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, n_experts=128, top_k=2, moe_d_ff=4864, dense_parallel=True,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
    moe_capacity_factor=1.25,
))
