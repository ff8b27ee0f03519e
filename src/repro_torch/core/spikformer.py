"""Spikformer V2-8-512-IAND, inference half (port of
``repro.core.spikformer``).

SCS stem of four 2x2/s2 convs (224 -> 14; 3 -> 64 -> 128 -> 256 -> 512; an
8-bit image into conv0 => SSSC, spikes into conv1..3 => ZSC), 8 encoder
blocks of SSA + MLP (512 -> 2048 -> 512) with IAND spike residuals, then a
rate decode over T and a linear head. Parameters are nested dicts of
tensors with the reference's keys and layouts.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .lif import bn_init, fold_bn


@dataclasses.dataclass(frozen=True)
class SpikformerConfig:
    img_size: int = 224
    in_channels: int = 3
    timesteps: int = 4
    dim: int = 512
    depth: int = 8
    heads: int = 8
    mlp_ratio: int = 4
    num_classes: int = 1000
    scs_channels: tuple = (64, 128, 256, 512)
    residual: str = "iand"          # "iand" (SEW IAND, keeps binary) or "add"
    attn_scale: float = 0.125

    @property
    def tokens(self) -> int:
        side = self.img_size // (2 ** len(self.scs_channels))
        return side * side

    def scaled(self, *, img_size=32, dim=64, depth=2, heads=2, classes=10,
               timesteps=None):
        """Reduced config for CPU tests; ``timesteps`` overrides T."""
        return dataclasses.replace(
            self, img_size=img_size, dim=dim, depth=depth, heads=heads,
            num_classes=classes, scs_channels=(8, 16, 32, dim),
            timesteps=self.timesteps if timesteps is None else timesteps)


def _linear(gen, d_in: int, d_out: int, *, bias: bool = False) -> dict:
    """LeCun-normal kernel: a standard normal truncated to [-2, 2], times
    1/sqrt(fan_in) (the reference's ``linear_init``)."""
    kernel = torch.empty(d_in, d_out)
    torch.nn.init.trunc_normal_(kernel, a=-2.0, b=2.0, generator=gen)
    p = {"kernel": kernel * (1.0 / math.sqrt(max(1, d_in)))}
    if bias:
        p["bias"] = torch.zeros(d_out)
    return p


def init(generator: torch.Generator, cfg: SpikformerConfig) -> dict:
    """Training-form parameters on the CPU with the reference's shapes and
    distributions (the numbers differ from JAX's: parity tests feed the
    reference's trees through ``repro_torch.weights``)."""
    p = {"scs": {}, "blocks": {},
         "head": _linear(generator, cfg.dim, cfg.num_classes, bias=True)}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.scs_channels):
        kernel = torch.randn((2, 2, cin, cout), generator=generator)
        p["scs"][f"conv{i}"] = {"kernel": kernel * (1.0 / math.sqrt(4.0 * cin)),
                                "bn": bn_init(cout)}
        cin = cout
    hidden = cfg.dim * cfg.mlp_ratio
    for i in range(cfg.depth):
        ssa = {}
        for name in ("wq", "wk", "wv", "wo"):
            ssa[name] = _linear(generator, cfg.dim, cfg.dim)
            ssa[name + "_bn"] = bn_init(cfg.dim)
        p["blocks"][f"b{i}"] = {"ssa": ssa, "mlp": {
            "fc1": _linear(generator, cfg.dim, hidden),
            "fc1_bn": bn_init(hidden),
            "fc2": _linear(generator, hidden, cfg.dim),
            "fc2_bn": bn_init(cfg.dim),
        }}
    return p


def fold_inference_params(params: dict, cfg: SpikformerConfig) -> dict:
    """Fold every BN into its preceding conv/linear: a tree of
    {kernel, bias} layers (conv kernels flattened to (4*cin, cout), conv0's
    scaled by 1/255 for 8-bit pixels)."""
    out = {"scs": {}, "blocks": {}, "head": params["head"]}
    for i in range(len(cfg.scs_channels)):
        c = params["scs"][f"conv{i}"]
        kern = c["kernel"] if i > 0 else c["kernel"] * (1.0 / 255.0)
        kf, bf = fold_bn(kern.reshape(-1, kern.shape[-1]), None, c["bn"])
        out["scs"][f"conv{i}"] = {"kernel": kf, "bias": bf}
    for bi, blk in params["blocks"].items():
        fb = {"ssa": {}, "mlp": {}}
        for wn in ("wq", "wk", "wv", "wo"):
            kf, bf = fold_bn(blk["ssa"][wn]["kernel"], None,
                             blk["ssa"][wn + "_bn"])
            fb["ssa"][wn] = {"kernel": kf, "bias": bf}
        for fc in ("fc1", "fc2"):
            kf, bf = fold_bn(blk["mlp"][fc]["kernel"], None,
                             blk["mlp"][fc + "_bn"])
            fb["mlp"][fc] = {"kernel": kf, "bias": bf}
        out["blocks"][bi] = fb
    return out


def forward_folded(folded: dict, images_u8: torch.Tensor,
                   cfg: SpikformerConfig, *, backend,
                   layer_occupancy: dict | None = None) -> torch.Tensor:
    """The inference forward over a BN-folded (optionally int8-quantized,
    optionally route-annotated) tree through ``backend``: matmuls and LIF
    comparisons only, every activation between layers a spike train. The
    op order is the reference's. ``layer_occupancy`` maps the paths of
    layers a plan routed "lut_sparse" to their calibrated chunk
    occupancy; it reaches a backend method as ``occupancy`` only for those
    layers. Returns (B, num_classes) logits."""
    t = cfg.timesteps
    occ = layer_occupancy or {}

    def extra(path):
        o = occ.get(path)
        return {} if o is None else {"occupancy": o}

    def wssl(z, layer, path):
        return backend.wssl_lif(z, layer["kernel"], layer["bias"], t=t,
                                scale=layer.get("scale"), lut=layer.get("lut"),
                                kmajor=layer.get("kernel_kmajor"),
                                bf16x3=layer.get("kernel_bf16x3"),
                                **extra(path))

    c0 = folded["scs"]["conv0"]
    x = backend.sssc_lif(images_u8, c0["kernel"], c0["bias"], t=t,
                         scale=c0.get("scale"), lut=c0.get("lut"),
                         **extra("scs/conv0"))
    for i in range(1, len(cfg.scs_channels)):
        ci = folded["scs"][f"conv{i}"]
        x = backend.zsc_lif(x, ci["kernel"], ci["bias"], t=t,
                            scale=ci.get("scale"), lut=ci.get("lut"),
                            kmajor=ci.get("kernel_kmajor"),
                            bf16x3=ci.get("kernel_bf16x3"),
                            **extra(f"scs/conv{i}"))
    x = backend.to_tokens(x)

    for i in range(cfg.depth):
        blk = folded["blocks"][f"b{i}"]
        ssa, mlp = blk["ssa"], blk["mlp"]
        bp = f"blocks/b{i}"
        q = wssl(x, ssa["wq"], f"{bp}/ssa/wq")
        k = wssl(x, ssa["wk"], f"{bp}/ssa/wk")
        v = wssl(x, ssa["wv"], f"{bp}/ssa/wv")
        att = backend.stdp_lif(q, k, v, heads=cfg.heads,
                               scale=cfg.attn_scale, t=t)
        att = wssl(att, ssa["wo"], f"{bp}/ssa/wo")
        x = backend.residual(att, x, cfg.residual)
        # a backend may fuse fc1 -> LIF -> fc2 into one kernel; None means
        # "not here" and the two-layer composition runs (bit-identical)
        pair = getattr(backend, "mlp_pair_lif", None)
        s2 = None if pair is None else pair(x, mlp["fc1"], mlp["fc2"], t=t,
                                            **extra(f"{bp}/mlp/fc1"))
        if s2 is None:
            s2 = wssl(wssl(x, mlp["fc1"], f"{bp}/mlp/fc1"), mlp["fc2"],
                      f"{bp}/mlp/fc2")
        x = backend.residual(s2, x, cfg.residual)

    rate = backend.rate(x, t=t)                         # (B, D)
    head = folded["head"]
    logits = rate @ head["kernel"].to(rate.dtype)
    if "bias" in head:
        logits = logits + head["bias"].to(logits.dtype)
    return logits
