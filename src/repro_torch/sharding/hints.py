"""Activation sharding hints (port of ``repro.sharding.hints``).

``shard_hint(x, "dp", None, "model")`` pins a tensor's layout when a mesh
is active (``compat.set_mesh``), ``x`` is a ``DTensor`` and the dims
divide evenly; otherwise it returns ``x`` unchanged, so model code runs
as it is on one device. "dp" expands to the ("pod", "data") axis group on
multi-pod meshes. The pin is a ``DTensor.redistribute`` to the spec's
placements (mesh axes the spec does not name replicate), the port's
``with_sharding_constraint``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from .compat import as_abstract, get_abstract_mesh
from .rules import placements


def hint_spec(shape, dims, am) -> tuple:
    """The reference's spec for ``dims`` over a tensor of ``shape`` on the
    mesh ``am``: each named axis kept where it divides its dim."""
    names = am.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    spec = []
    for d, size in zip(dims, shape):
        if d is None:
            spec.append(None)
        elif d == "dp":
            dpsize = math.prod(am.shape[a] for a in dp)
            ok = dp and size % dpsize == 0
            spec.append((dp if len(dp) > 1 else dp[0]) if ok else None)
        else:
            ok = d in names and size % am.shape[d] == 0
            spec.append(d if ok else None)
    return tuple(spec)


def shard_hint(x, *dims):
    am = get_abstract_mesh()
    if am.empty or not isinstance(x, DTensor):
        return x
    want = placements(am, hint_spec(x.shape, dims, am))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _GradLike(torch.autograd.Function):
    """The identity, whose gradient is laid out as its input was."""

    @staticmethod
    def forward(ctx, x):
        # a partial sum's gradient is whole
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_like(x):
    """``x``, whose gradient arrives in ``x``'s own layout (a plain tensor
    as it is): where a tensor feeds two branches, or a view, torch 2.11's
    DTensor cannot add two gradients of other layouts (a shard and a
    partial sum) nor split a dim the gradient comes back sharded on."""
    return _GradLike.apply(x) if isinstance(x, DTensor) else x


def rowwise(fn, *xs, n_out: int = 1):
    """``fn(*xs)`` on each rank's batch rows: for an op with no DTensor
    rule whose rows are independent (MoE routing, dispatch and combine:
    each batch row is a routing group). Under ``local_map`` every tensor
    has its dim 0 over dp where that divides it and the rest replicated,
    and so has each of the ``n_out`` outputs; plain tensors go straight
    to ``fn``."""
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)
    if mesh is None:
        return fn(*xs)
    am = as_abstract(mesh)
    pl = list(placements(am, hint_spec((xs[0].shape[0],), ("dp",), am)))
    out_pl = pl if n_out == 1 else tuple(pl for _ in range(n_out))
    in_pl = tuple(pl if isinstance(x, DTensor) else None for x in xs)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*xs)
