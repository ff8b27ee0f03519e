"""Gradient compression with error feedback (port of
``repro.optim.compression``, its numerics).

``ef_compress`` quantizes gradients to int8 (or keeps the top-k by
magnitude) with an error-feedback accumulator, modelling what a compressed
cross-pod reduction delivers to the optimizer. The arithmetic is the
reference's op for op, so the result is its bits: int8 divides by the
scale ``max|g + e| / 127`` and rounds half to even (``torch.round``, as
``jnp.round``); top-k keeps every element whose magnitude is at least the
k-th largest, so ties keep more than k (``jax.lax.top_k``'s threshold).

The transport, ``compressed_psum_int8`` (an int8 all-gather across a mesh
axis), is a collective and comes with the port of ``repro.sharding``.
"""
from __future__ import annotations

import torch

from .adamw import _map


def ef_init(params):
    """f32 zeros beside each leaf: the error-feedback accumulator."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def ef_compress(grads, ef, *, method: str = "int8", topk_frac: float = 0.01):
    """Quantize or sparsify ``grads`` with error feedback. Returns
    ``(grads', ef')``: the dequantized f32 gradients and what they left
    out."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        if method == "int8":
            scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g32 / scale), -127, 127)
            deq = q * scale
        elif method == "topk":
            k = max(1, int(g32.numel() * topk_frac))
            flat = g32.reshape(-1)
            thresh = torch.topk(flat.abs(), k).values[-1]
            deq = torch.where(flat.abs() >= thresh, flat, 0.0).reshape(
                g32.shape)
        else:
            raise ValueError(method)
        return deq, g32 - deq

    out = _map(one, grads, ef)
    return (_map(lambda t: t[0], out), _map(lambda t: t[1], out))
