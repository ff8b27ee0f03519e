"""Spikformer V2-8-512-IAND (port of ``repro.core.spikformer``).

SCS stem of four 2x2/s2 convs (224 -> 14; 3 -> 64 -> 128 -> 256 -> 512; an
8-bit image into conv0 => SSSC, spikes into conv1..3 => ZSC), 8 encoder
blocks of SSA + MLP (512 -> 2048 -> 512) with IAND spike residuals, then a
rate decode over T and a linear head. Parameters are nested dicts of
tensors with the reference's keys and layouts. ``apply`` and ``loss_fn``
are the float graph that surrogate-gradient BPTT trains (BN on batch
statistics under ``train=True``); ``train_step`` is one step of that
training (the reference example's jitted step), and ``make_train_step``
runs it over state it owns, as one CUDA graph on the card.
``forward_folded`` is the inference graph over BN-folded weights and a
backend.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import TrainStep as OwnedStateStep, resolve_device
from ..nn.module import map_with_path
from ..optim import adamw
from .lif import bn_apply, bn_init, bn_train_apply, fold_bn, tflif
from .spike import rate_decode
from .ssa import linear_init, ssa_apply, ssa_init
from .unified import sssc, wssl, zsc


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


def init(generator: torch.Generator, cfg: SpikformerConfig) -> dict:
    """Training-form parameters on the CPU with the reference's shapes and
    distributions (the numbers differ from JAX's: parity tests feed the
    reference's trees through ``repro_torch.weights``)."""
    p = {"scs": {}, "blocks": {},
         "head": linear_init(generator, cfg.dim, cfg.num_classes, bias=True)}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.scs_channels):
        kernel = torch.randn((2, 2, cin, cout), generator=generator)
        p["scs"][f"conv{i}"] = {"kernel": kernel * (1.0 / math.sqrt(4.0 * cin)),
                                "bn": bn_init(cout)}
        cin = cout
    hidden = cfg.dim * cfg.mlp_ratio
    for i in range(cfg.depth):
        p["blocks"][f"b{i}"] = {"ssa": ssa_init(generator, cfg.dim,
                                                cfg.heads), "mlp": {
            "fc1": linear_init(generator, cfg.dim, hidden),
            "fc1_bn": bn_init(hidden),
            "fc2": linear_init(generator, hidden, cfg.dim),
            "fc2_bn": bn_init(cfg.dim),
        }}
    return p


def _combine(new: torch.Tensor, res: torch.Tensor, mode: str):
    if mode == "iand":
        # SEW IAND: (NOT new) AND res, which keeps activations binary
        return (1.0 - new) * res
    return new + res


def _bn_lif(pbn: dict, y: torch.Tensor, axes, *, train: bool):
    if train:
        y, stats = bn_train_apply(pbn, y, axes=axes)
    else:
        y, stats = bn_apply(pbn, y), None
    return tflif(y), stats


def apply(params: dict, images_u8: torch.Tensor, cfg: SpikformerConfig, *,
          train: bool = False) -> tuple:
    """The float graph: (B, H, W, C) uint8 images -> ``(logits,
    stats)``, stats the BN running-stat updates under ``train=True``
    (batch statistics, through which gradients flow) and None leaves in
    eval (the running statistics). The op order is the reference's."""
    t = cfg.timesteps
    stats = {"scs": {}, "blocks": {}}
    # conv0: SSSC on the 8-bit image, once; the same accumulator every step
    c0 = params["scs"]["conv0"]
    y = sssc(images_u8, c0["kernel"] * (1.0 / 255.0))  # (B,H/2,W/2,C0)
    y = y[None].expand(t, *y.shape)
    x, stats["scs"]["conv0"] = _bn_lif(c0["bn"], y, (0, 1, 2, 3),
                                       train=train)
    for i in range(1, len(cfg.scs_channels)):           # ZSC on spikes
        ci = params["scs"][f"conv{i}"]
        x, stats["scs"][f"conv{i}"] = _bn_lif(
            ci["bn"], zsc(x, ci["kernel"]), (0, 1, 2, 3), train=train)
    tt, b, h, w, c = x.shape
    x = x.reshape(tt, b, h * w, c)                      # (T, B, N, D)
    for i in range(cfg.depth):
        blk = params["blocks"][f"b{i}"]
        bstats = {}
        attn, bstats["ssa"] = ssa_apply(blk["ssa"], x, heads=cfg.heads,
                                        scale=cfg.attn_scale, train=train)
        x = _combine(attn, x, cfg.residual)
        mlp = blk["mlp"]
        s1, bstats["fc1_bn"] = _bn_lif(mlp["fc1_bn"],
                                       wssl(x, mlp["fc1"]["kernel"]),
                                       (0, 1, 2), train=train)
        s2, bstats["fc2_bn"] = _bn_lif(mlp["fc2_bn"],
                                       wssl(s1, mlp["fc2"]["kernel"]),
                                       (0, 1, 2), train=train)
        x = _combine(s2, x, cfg.residual)
        stats["blocks"][f"b{i}"] = bstats
    rate = rate_decode(x, axis=0).mean(dim=1)           # (B, D)
    head = params["head"]
    logits = rate @ head["kernel"]
    if "bias" in head:
        logits = logits + head["bias"].to(logits.dtype)
    return logits, stats


def merge_bn_stats(params: dict, stats: dict) -> dict:
    """Write the EMA'd BN running stats of a training step into a new
    param tree (``stats`` from ``apply(..., train=True)``; None leaves are
    skipped). Untouched subtrees are shared with ``params``."""
    out = {**params, "scs": dict(params["scs"]),
           "blocks": dict(params["blocks"])}
    for name, st in stats.get("scs", {}).items():
        if st is not None:
            conv = out["scs"][name] = dict(out["scs"][name])
            conv["bn"] = {**conv["bn"], **st}
    for bname, bstats in stats.get("blocks", {}).items():
        blk = out["blocks"][bname] = {**out["blocks"][bname]}
        blk["ssa"], blk["mlp"] = dict(blk["ssa"]), dict(blk["mlp"])
        for wn, st in (bstats.get("ssa") or {}).items():
            if st is not None:
                blk["ssa"][wn] = {**blk["ssa"][wn], **st}
        for fc in ("fc1_bn", "fc2_bn"):
            st = bstats.get(fc)
            if st is not None:
                blk["mlp"][fc] = {**blk["mlp"][fc], **st}
    return out


def loss_fn(params: dict, batch: dict, cfg: SpikformerConfig, *,
            train: bool = True) -> tuple:
    """Cross-entropy over classes: returns ``(loss, (accuracy, stats))``;
    accuracy counts the first index of the largest logit, as
    ``jnp.argmax``."""
    logits, stats = apply(params, batch["image"], cfg, train=train)
    labels = batch["label"].to(torch.long)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=1).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, (acc, stats)


def value_and_grad(params: dict, batch: dict, cfg: SpikformerConfig, *,
                   train: bool = True) -> tuple:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` on the port: returns
    ``((loss, (accuracy, stats)), grads)``, loss and accuracy detached,
    ``grads`` a tree like ``params`` with zeros for the leaves the loss
    does not reach (the BN running stats under ``train=True``). Eager
    autograd through the whole graph (BPTT over T)."""
    leaves = []

    def track(tree):
        if isinstance(tree, dict):
            return {k: track(v) for k, v in tree.items()}
        leaf = tree.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    loss, (acc, stats) = loss_fn(track(params), batch, cfg, train=train)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        g = next(grads)
        return torch.zeros_like(tree) if g is None else g

    return (loss.detach(), (acc, stats)), fill(params)


def train_step(params: dict, opt: dict, batch: dict, cfg: SpikformerConfig,
               opt_cfg: adamw.OptConfig) -> tuple:
    """One training step, the reference example's jitted ``step``:
    ``value_and_grad``, ``adamw.update``, then the EMA'd BN stats merged.
    Functional: returns ``(params, opt, loss, accuracy, metrics)``
    (``metrics``: ``grad_norm`` and ``lr``), its inputs left as they
    were."""
    (loss, (acc, stats)), grads = value_and_grad(params, batch, cfg)
    params, opt, metrics = adamw.update(grads, opt, params, opt_cfg)
    return merge_bn_stats(params, stats), opt, loss, acc, metrics


TRAIN_METRICS = ("loss", "accuracy", "grad_norm", "lr")


class TrainStep(OwnedStateStep):
    """``train_step`` over state the step owns (``device.TrainStep``):
    params, AdamW moments, the step counter and the BN running stats live
    in tensors that never move, and each call writes the step's new values
    into them. ``graphed`` (``make_train_step(jit=True)`` on the card):
    one CUDA graph replays the whole step (forward, BPTT, AdamW, the BN
    merge), as the reference jits it; else the same body runs eagerly.

    Called as the port's examples call it: ``step(batch)`` loads a batch
    (uint8 images, integer labels; on the host or the card) and returns
    the 0-d f32 ``loss``, ``accuracy``, ``grad_norm`` and ``lr`` of the
    step on the device, unread. ``state()`` hands back a copy of the
    params and the optimizer state. The learning rate and the bias
    corrections come from the device's step counter, so a replay reads
    nothing on the host."""

    def __call__(self, batch: dict) -> dict:
        return self.run(batch)


def make_train_step(params: dict, opt: dict, cfg: SpikformerConfig,
                    opt_cfg: adamw.OptConfig, *, device=None,
                    jit: bool = True) -> TrainStep:
    """The training step as the reference jits it: with ``jit`` on the
    card one CUDA graph, eager with ``jit=False`` or on the CPU. ``device``
    is the card unless the caller asks for the CPU; ``params`` and ``opt``
    (``adamw.init``'s tree) are copied there and left as they are."""
    device = resolve_device(device)

    def fn(params, opt, batch):
        params, opt, loss, acc, m = train_step(params, opt, batch, cfg,
                                               opt_cfg)
        return params, opt, {"loss": loss, "accuracy": acc, **m}

    def owned(_, t):
        return t.detach().to(device, copy=True)

    step = TrainStep(fn, TRAIN_METRICS, ("image", "label"), device=device,
                     graphed=jit and device.type == "cuda",
                     what="the training step")
    step.own(map_with_path(owned, params), map_with_path(owned, opt))
    return step


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
