"""ArchConfig and the config registry (port of ``repro.configs.base``).

The fields and ``reduced()`` are the reference's, so one config drives both
packages. The dry-run tooling (``ShapeSpec``, ``cell_applicable``,
``input_specs``) is not ported. Only the configs whose model code is ported
are registered: ``get_config`` of any other arch raises.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    qkv_bias: bool = False
    qk_norm: bool = False
    mrope_sections: tuple | None = None
    sliding_window: int | None = None
    global_layers: tuple = ()
    attn_chunk: int = 512

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_parallel: bool = False
    moe_capacity_factor: float = 1.25
    moe_norm_topk: bool = True

    # ssm (mamba2 / hymba)
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2

    # encdec (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    n_frames: int = 0

    # vlm stub
    img_tokens: int = 0

    # misc
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's TP padding;
        kept so that parameter trees cross between the packages)."""
        return -(-self.vocab // 256) * 256

    def encoder_cfg(self) -> "ArchConfig":
        """The encoder's config (Whisper): non-causal, no RoPE, no
        cross-attention, no experts, no window."""
        return dataclasses.replace(
            self, causal=False, cross_attention=False, n_experts=0,
            sliding_window=None, use_rope=False)

    def reduced(self, **overrides) -> "ArchConfig":
        """Same-family tiny config, runnable on the CPU; keeps every
        structural flag (GQA, MoE, SSM, M-RoPE, windows...)."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=2 if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            attn_chunk=64,
            remat=False,
        )
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=64,
                      moe_capacity_factor=8.0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_expand=2)
        if self.family == "encdec":
            kw.update(encoder_layers=2, n_frames=16)
        if self.family == "vlm":
            kw.update(img_tokens=8)
        if self.sliding_window is not None:
            kw.update(sliding_window=32, global_layers=(0,))
        if self.mrope_sections is not None:
            kw.update(mrope_sections=(4, 6, 6))
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        mod = arch_id.replace("-", "_").replace(".", "_")
        name = f"{__package__}.{mod}"
        try:
            importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise
            raise KeyError(f"arch {arch_id!r} is not ported yet; the port "
                           f"has {sorted(_REGISTRY)}") from None
    return _REGISTRY[arch_id]
