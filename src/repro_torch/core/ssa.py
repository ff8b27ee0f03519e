"""Spiking Self-Attention, the attention of Spikformer V2 (port of
``repro.core.ssa``).

Q, K and V are spike tensors made by Linear + BN + LIF stacks; the
attention map is ``(Q K^T) V * scale`` with no softmax (spikes are
non-negative, so a fixed scale stands in for the normalisation), which is
what lets VESTA's STDP tiling consume V columns as they are produced. This
is the float graph training differentiates; inference runs the folded
graph through ``repro_torch.infer.backends``.
"""
from __future__ import annotations

import math

import torch

from .lif import bn_apply, bn_init, bn_train_apply, tflif
from .unified import stdp, wssl


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False) -> dict:
    """LeCun-normal kernel: a standard normal truncated to [-2, 2], times
    1/sqrt(fan_in) (the reference's ``linear_init``)."""
    kernel = torch.empty(d_in, d_out)
    torch.nn.init.trunc_normal_(kernel, a=-2.0, b=2.0, generator=gen)
    p = {"kernel": kernel * (1.0 / math.sqrt(max(1, d_in)))}
    if bias:
        p["bias"] = torch.zeros(d_out)
    return p


def ssa_init(gen: torch.Generator, dim: int, heads: int) -> dict:
    """wq, wk, wv, wo (dim x dim, no bias), drawn in that order, each with
    its BN."""
    p = {}
    for name in ("wq", "wk", "wv", "wo"):
        p[name] = linear_init(gen, dim, dim)
        p[name + "_bn"] = bn_init(dim)
    return p


def _lin_bn_lif(pw: dict, pbn: dict, x: torch.Tensor, *, train: bool):
    """(T, B, N, D) spikes -> Linear -> BN -> TFLIF -> spikes; returns
    ``(spikes, stats)``, stats None in eval."""
    y = wssl(x, pw["kernel"])                    # (T, B, N, F) accumulator
    if train:
        y, stats = bn_train_apply(pbn, y, axes=(0, 1, 2))
    else:
        y, stats = bn_apply(pbn, y), None
    return tflif(y), stats


def ssa_apply(p: dict, x: torch.Tensor, *, heads: int, scale: float,
              train: bool = False) -> tuple:
    """(T, B, N, D) spikes -> (T, B, N, D) spikes, plus the BN-stat
    updates ``{"wq_bn", "wk_bn", "wv_bn", "wo_bn"}``."""
    t, b, n, d = x.shape
    dh = d // heads
    new_stats = {}
    q, new_stats["wq_bn"] = _lin_bn_lif(p["wq"], p["wq_bn"], x, train=train)
    k, new_stats["wk_bn"] = _lin_bn_lif(p["wk"], p["wk_bn"], x, train=train)
    v, new_stats["wv_bn"] = _lin_bn_lif(p["wv"], p["wv_bn"], x, train=train)

    def to_heads(z):
        return z.reshape(t, b, n, heads, dh).permute(0, 1, 3, 2, 4)

    attn = stdp(to_heads(q), to_heads(k), to_heads(v), scale=scale)
    attn = tflif(attn)                       # spike the attention output
    attn = attn.permute(0, 1, 3, 2, 4).reshape(t, b, n, d)
    out, new_stats["wo_bn"] = _lin_bn_lif(p["wo"], p["wo_bn"], attn,
                                          train=train)
    return out, new_stats
