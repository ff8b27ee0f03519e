"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention+mamba heads in every layer,
sliding-window attention except 3 global layers (first/middle/last).
Meta-token prefix omitted. [arXiv:2411.13676; hf]
(Port of ``repro.configs.hymba_1_5b``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    sliding_window=2048, global_layers=(0, 15, 31),
    scan_layers=False,  # heterogeneous caches (ring vs full) per layer
))
