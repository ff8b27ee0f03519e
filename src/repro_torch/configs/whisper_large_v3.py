"""whisper-large-v3 [audio/encdec]: 32L enc + 32L dec, d_model=1280 20H
d_ff=5120 vocab=51866 — conv/mel frontend STUBBED (the caller provides
precomputed frame embeddings, 1500 frames); sinusoidal positions; gelu MLP;
layernorm. [arXiv:2212.04356; backbone only per brief]
(Port of ``repro.configs.whisper_large_v3``.)"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, encoder_layers=32, cross_attention=True, n_frames=1500,
    use_rope=False, norm="layernorm", act="gelu",
))
