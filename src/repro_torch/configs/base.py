"""ArchConfig, the shape registry and the config registry (port of
``repro.configs.base``): every (architecture x input-shape) cell of the
dry-run grid is addressable as (arch_id, shape_id) and yields the step's
input specs.

The fields, ``reduced()``, ``n_params()``, ``n_active_params()``,
``SHAPES``, ``ARCH_IDS`` and ``cell_applicable`` are the reference's, so one
config and one grid drive both packages. ``input_specs`` returns meta
tensors where the reference returns ``ShapeDtypeStruct``s: shapes and
dtypes, nothing allocated (``launch/dryrun.py`` traces against them).
``get_config`` of an arch id that names no ``ArchConfig`` raises
``KeyError``: an id with no config module, and ``spikformer-v2``, whose
module holds the paper's vision configs and registers none.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


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

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid with sliding windows)."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window is not None)

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

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        dh, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * dh * (h + 2 * kv) + h * dh * d
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        per_layer = 0
        if self.family != "ssm":
            per_layer += attn
        if self.family in ("ssm", "hybrid"):
            d_inner = self.ssm_expand * d
            heads = d_inner // self.ssm_head_dim
            per_layer += d * (2 * d_inner + 2 * self.ssm_groups
                              * self.ssm_state + heads) + d_inner * d
        if self.n_experts > 0:
            per_layer += d * self.n_experts \
                + 3 * self.n_experts * d * self.moe_d_ff
            if self.dense_parallel:
                per_layer += mlp
        elif self.family != "ssm" and f > 0:
            per_layer += mlp
        total = self.n_layers * per_layer + v * d
        if not self.tie_embeddings:
            total += v * d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + 2 * d * f) \
                + self.n_layers * attn  # cross attention
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        moe_all = 3 * self.n_experts * d * self.moe_d_ff
        moe_active = 3 * self.top_k * d * self.moe_d_ff
        return self.n_params() - self.n_layers * (moe_all - moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "stablelm-12b", "glm4-9b", "qwen1.5-110b", "smollm-360m", "hymba-1.5b",
    "whisper-large-v3", "mamba2-130m", "arctic-480b", "qwen3-moe-30b-a3b",
    "qwen2-vl-7b",
]

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
    if arch_id not in _REGISTRY:
        raise KeyError(f"arch {arch_id!r} names no ArchConfig: its module "
                       f"registers none (the LM archs are {ARCH_IDS})")
    return _REGISTRY[arch_id]


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (the brief's skip rules)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention at 500k — skipped per brief"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of this cell (the
    reference's ``ShapeDtypeStruct``s): no allocation. The decode cache is
    ``init_cache``'s tree on the meta device, ``cache_pos`` a 0-d int32."""
    i32, bf16 = torch.int32, torch.bfloat16
    b, s = shape.batch, shape.seq

    def sds(shp, dt=i32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s))}
        if shape.kind == "train":
            batch["labels"] = sds((b, s))
        if cfg.family == "vlm":
            batch["image_embeds"] = sds((b, cfg.img_tokens, cfg.d_model),
                                        bf16)
            batch["mrope_positions"] = sds((3, b, s))
        if cfg.family == "encdec":
            batch["frames"] = sds((b, cfg.n_frames, cfg.d_model), bf16)
        return {"batch": batch}

    # decode: one new token against a seq-long cache
    from ..nn.transformer import init_cache
    cache = init_cache(cfg, b, s, device="meta")
    batch = {"tokens": sds((b, 1)), "cache_pos": sds(())}
    if cfg.family == "vlm":
        batch["mrope_positions"] = sds((3, b, 1))
    return {"batch": batch, "cache": cache}
