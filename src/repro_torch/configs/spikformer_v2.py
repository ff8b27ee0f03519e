"""spikformer-v2-8-512 — the paper's own model (VESTA's workload), exposed
alongside the 10 LM architectures (port of ``repro.configs.spikformer_v2``).
It is a vision SNN, not an LM, so it lives outside the (arch x LM-shape)
dry-run grid and registers no ``ArchConfig``: ``get_config("spikformer-v2")``
raises ``KeyError``, as the reference's does. Its production instantiation
is the full 224x224 ImageNet config below; its launchers are
``examples/torch_train_spikformer.py`` and ``core/spikformer.py``.
"""
import dataclasses

from ..core.spikformer import SpikformerConfig

# full paper config: 8 encoder blocks, dim 512, T=4, 224px, 1000 classes
CONFIG = SpikformerConfig()

# CPU-scale smoke config (used by tests/examples)
REDUCED = CONFIG.scaled()

# Long-timestep variants (Spike-driven Transformer V2 / Spikingformer
# workload shapes): T=16 -> ceil(16/8)=2 packed plane groups per neuron.
CONFIG_T16 = dataclasses.replace(CONFIG, timesteps=16)
REDUCED_T16 = REDUCED.scaled(timesteps=16)
