"""LIF constants and BN folding (port of ``repro.core.lif``, inference half).

Dynamics (v_reset = 0): ``h = v + (x - v) / tau``; spike iff ``h >= v_th``;
hard reset. The BN that precedes every LIF is folded into the producing
conv/linear so it never runs as a layer of its own.
"""
from __future__ import annotations

import torch

TAU = 2.0
V_TH = 1.0


def bn_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def fold_bn(kernel: torch.Tensor, bias, bn: dict, *, eps: float = 1e-5):
    """Fold inference BN into the preceding linear/conv: returns
    ``(kernel', bias')`` with ``BN(x @ k + b) == x @ k' + b'``; kernel is
    (..., d_in, C). ``rsqrt`` may differ from XLA's by an ulp, so parity
    tests feed the reference's folded tree and hold this fold to a
    tolerance."""
    inv = torch.rsqrt(bn["var"].to(torch.float32) + eps)
    g = bn["scale"].to(torch.float32) * inv
    b = bn["bias"].to(torch.float32) - bn["mean"].to(torch.float32) * g
    kernel_f = kernel.to(torch.float32) * g
    bias_f = b if bias is None else bias.to(torch.float32) * g + b
    return kernel_f.to(kernel.dtype), bias_f
