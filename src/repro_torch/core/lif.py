"""LIF dynamics and BN folding (port of ``repro.core.lif``, inference
half).

Dynamics (v_reset = 0): ``h = v + (x - v) / tau``; spike iff ``h >= v_th``;
hard reset. The BN that precedes every LIF is folded into the producing
conv/linear so it never runs as a layer of its own. ``tflif`` is the float
forward the reference backend runs: {0,1} f32 spikes with an explicit T
axis. The surrogate gradient waits for the training slice.
"""
from __future__ import annotations

import torch

TAU = 2.0
V_TH = 1.0


def lif_step(v, x, *, tau: float = TAU, v_th=V_TH):
    """One LIF timestep: returns ``(v_next, spike)`` as f32, in the
    reference's op order (``v + (x - v) / tau``, spike iff ``h - v_th >=
    0``, ``v_next = h * (1 - s)``), each op rounded on its own: torch runs
    them as separate elementwise kernels, so nothing is contracted into a
    fused multiply-add. ``v_th`` may be a per-channel tensor (the int8
    scale fold)."""
    h = v + (x - v) / tau
    s = (h - v_th >= 0.0).to(torch.float32)
    return h * (1.0 - s), s


def tflif(x: torch.Tensor, *, tau: float = TAU, v_th=V_TH,
          time_axis: int = 0) -> torch.Tensor:
    """Temporal-fused LIF forward: (T, ...) accumulators -> (T, ...) {0,1}
    f32 spikes, the membrane carried over all T from zero."""
    x = torch.movedim(x.to(torch.float32), time_axis, 0)
    v = torch.zeros_like(x[0])
    out = []
    for xt in x:
        v, s = lif_step(v, xt, tau=tau, v_th=v_th)
        out.append(s)
    return torch.movedim(torch.stack(out), 0, time_axis)


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
