"""Gradient compression with error feedback (port of
``repro.optim.compression``, its numerics).

``ef_compress`` quantizes gradients to int8 (or keeps the top-k by
magnitude) with an error-feedback accumulator, modelling what a compressed
cross-pod reduction delivers to the optimizer. The arithmetic is the
reference's op for op, so the result is its bits: int8 divides by the
scale ``max|g + e| / 127`` and rounds half to even (``torch.round``, as
``jnp.round``); top-k keeps every element whose magnitude is at least the
k-th largest, so ties keep more than k (``jax.lax.top_k``'s threshold).

The transport, ``compressed_psum_int8``, is the collective a multi-pod
deployment runs across its slow boundary: an int8 payload and an f32
scale a rank all-gathered across a mesh axis, then dequantised and
averaged locally (the reference's ``shard_map`` collective; 4x fewer
bytes on the wire than an f32 all-reduce).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .adamw import _map


def ef_init(params):
    """f32 zeros beside each leaf (in its layout, for a DTensor): the
    error-feedback accumulator."""
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _group(axis):
    """The process group of ``axis``: a ``ProcessGroup``, a 1-D
    ``DeviceMesh``, or the name of a dim of the active mesh
    (``sharding.set_mesh``), as the reference names an axis."""
    if isinstance(axis, str):
        from ..sharding.compat import get_abstract_mesh
        mesh = get_abstract_mesh().device_mesh
        if mesh is None:
            raise ValueError(f"axis {axis!r} needs an active mesh with "
                             "devices (sharding.set_mesh)")
        return mesh.get_group(axis)
    if hasattr(axis, "get_group"):
        return axis.get_group()
    return axis


def compressed_psum_int8(x, axis):
    """The mean of each rank's ``x`` across ``axis`` (a mesh dim's name
    under ``set_mesh``, a 1-D ``DeviceMesh`` or a ``ProcessGroup``) with
    an int8 payload: each rank quantises x by its own scale ``max|x| /
    127`` (rounding half to even), all-gathers the int8 tensors and the
    f32 scales, and dequantises and averages them locally, in rank
    order. ``x`` is this rank's local tensor (the reference's
    ``shard_map`` body sees local values)."""
    if hasattr(x, "to_local"):
        x = x.to_local()
    group = _group(axis)
    n = dist.get_world_size(group)
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)     # int8 on the wire
    dist.all_gather(scales, scale.reshape(1), group=group)
    deq = (torch.stack(qs).to(torch.float32)
           * torch.cat(scales).reshape((-1,) + (1,) * x.dim()))
    return deq.sum(dim=0) / n


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
