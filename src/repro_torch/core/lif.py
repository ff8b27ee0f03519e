"""LIF dynamics with the atan surrogate gradient, training BN, and BN
folding (port of ``repro.core.lif``).

Dynamics (v_reset = 0): ``h = v + (x - v) / tau``; spike iff ``h >= v_th``;
hard reset. The fire is ``spike_fn``: Heaviside forward, and backward the
atan surrogate ``alpha / (2 * (1 + (pi/2 * alpha * u)^2))``, so BPTT runs
through the membrane and the hard reset as the reference's ``lax.scan``
differentiates them. ``tflif`` is the float forward the reference backend
and training run: {0,1} f32 spikes with an explicit T axis. The BN that
precedes every LIF is batch-normalised in training (``bn_train_apply``)
and folded into the producing conv/linear for inference (``fold_bn``).
"""
from __future__ import annotations

import math

import torch

TAU = 2.0
V_TH = 1.0
SURROGATE_ALPHA = 2.0
# the reference's ``jnp.pi / 2.0 * SURROGATE_ALPHA``: one Python constant
# times u, so the f32 products round alike
_SURROGATE_SLOPE = math.pi / 2.0 * SURROGATE_ALPHA


class _SpikeFn(torch.autograd.Function):
    """Heaviside of u = membrane - threshold, atan surrogate backward."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return (u >= 0.0).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        z = _SURROGATE_SLOPE * u
        # a true division: torch's ``scalar / tensor`` multiplies by the
        # reciprocal, which rounds differently from the reference's divide
        sg = torch.div(torch.full_like(u, SURROGATE_ALPHA),
                       2.0 * (1.0 + z * z))
        return g * sg


def spike_fn(u: torch.Tensor) -> torch.Tensor:
    """Heaviside with the atan surrogate gradient; ``u = h - v_th``."""
    return _SpikeFn.apply(u)


def lif_step(v, x, *, tau: float = TAU, v_th=V_TH):
    """One LIF timestep: returns ``(v_next, spike)`` as f32, in the
    reference's op order (``v + (x - v) / tau``, spike iff ``h - v_th >=
    0``, ``v_next = h * (1 - s)``), each op rounded on its own: torch runs
    them as separate elementwise kernels, so nothing is contracted into a
    fused multiply-add. ``v_th`` may be a per-channel tensor (the int8
    scale fold). Differentiable through ``spike_fn``."""
    h = v + (x - v) / tau
    s = spike_fn(h - v_th)
    return h * (1.0 - s), s


def tflif(x: torch.Tensor, *, tau: float = TAU, v_th=V_TH,
          time_axis: int = 0) -> torch.Tensor:
    """Temporal-fused LIF: (T, ...) accumulators -> (T, ...) {0,1} f32
    spikes, the membrane carried over all T from zero; nothing is
    detached, so gradients flow through every step (BPTT)."""
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


def bn_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN over the last axis (the training graph's eval
    form, before folding)."""
    inv = torch.rsqrt(p["var"].to(torch.float32) + eps)
    g = p["scale"].to(torch.float32) * inv
    b = p["bias"].to(torch.float32) - p["mean"].to(torch.float32) * g
    return x.to(torch.float32) * g + b


def batch_stats(x: torch.Tensor, axes) -> tuple:
    """Training-mode BN statistics over ``axes``: the mean and the
    population variance (``correction=0``, as ``jnp.var``)."""
    axes = tuple(axes)
    return (torch.mean(x, dim=axes),
            torch.var(x, dim=axes, correction=0))


def bn_train_apply(p: dict, x: torch.Tensor, axes, *, eps: float = 1e-5,
                   momentum: float = 0.9) -> tuple:
    """Training BN: normalise with the batch statistics, through which
    gradients flow; returns ``(y, {"mean", "var"})``, the running stats
    moved by an EMA and detached (the reference returns them as an
    auxiliary output, which carries no gradient)."""
    x32 = x.to(torch.float32)
    mean, var = batch_stats(x32, axes)
    inv = torch.rsqrt(var + eps)
    y = ((x32 - mean) * inv * p["scale"].to(torch.float32)
         + p["bias"].to(torch.float32))
    new = {"mean": (momentum * p["mean"]
                    + (1 - momentum) * mean).detach(),
           "var": (momentum * p["var"]
                   + (1 - momentum) * var).detach()}
    return y.to(x.dtype), new


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
