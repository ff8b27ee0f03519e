"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-135M scaled; hf]
(Port of ``repro.configs.smollm_360m``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, tie_embeddings=True,
))
