"""Spike-form data handling: temporal plane-group packing and encodings.

Port of ``repro.core.spike``. Spikes live packed 8 per uint8: bit j of
plane group g is timestep ``8g + j`` (temporal packing, used by ZSC / WSSL /
STDP), or bit p of a pixel byte is its value plane p (bit-plane packing,
used by SSSC). A T-step train carries ``G = ceil(T/8)`` groups on a leading
axis, even for T <= 8; bits past T-1 in the last group are zero.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import constant


def _shifts(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """The 8 bit positions shaped (8, 1, ..., 1) for ``ndim`` trailing axes,
    on ``x``'s device (made there once)."""
    shifts = constant("shifts_u8", x.device, lambda d: torch.arange(
        8, dtype=torch.uint8, device=d))
    return shifts.reshape((8,) + (1,) * ndim)


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a binary {0,1} tensor along ``axis`` (a multiple of 8 long)
    into uint8, bit i of a byte = element ``8j + i``; the axis shrinks 8x."""
    x = torch.movedim(x, axis, -1)
    if x.shape[-1] % 8:
        raise ValueError(f"pack axis {x.shape[-1]} not a multiple of 8")
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 8, 8).to(torch.uint8)
    packed = (x << _shifts(x, 0)).sum(dim=-1, dtype=torch.uint8)
    return torch.movedim(packed, -1, axis)


def unpack_bits(x: torch.Tensor, axis: int = -1, *, count: int = 8,
                dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_bits``: uint8 -> {0,1}; the axis grows 8x (or
    ``count`` bits a byte, the low ones, for ``count < 8``)."""
    x = torch.movedim(x, axis, -1)
    bits = (x.unsqueeze(-1) >> _shifts(x, 0)[:count]) & 1
    bits = bits.reshape(*x.shape[:-1], x.shape[-1] * count).to(dtype)
    return torch.movedim(bits, -1, axis)


def num_plane_groups(t: int) -> int:
    """Number of uint8 plane groups needed for a T-timestep spike train."""
    if t < 1:
        raise ValueError(f"need t >= 1, got {t}")
    return -(-t // 8)


def pack_timesteps(spikes: torch.Tensor, *, time_axis: int = 0) -> torch.Tensor:
    """(T, ...) binary spikes -> (G, ...) uint8 plane groups, bit j of group
    g = timestep ``8g + j``; bits past T-1 are zero."""
    t = spikes.shape[time_axis]
    g = num_plane_groups(t)
    x = torch.movedim(spikes, time_axis, 0).to(torch.uint8)
    pad = g * 8 - t
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)
    x = x.reshape(g, 8, *x.shape[1:])
    # the 8 shifted bits are disjoint, so their sum is their bitwise OR
    return (x << _shifts(x, x.ndim - 2)).sum(dim=1, dtype=torch.uint8)


def unpack_timesteps(packed: torch.Tensor, t: int, *, time_axis: int = 0,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_timesteps``: (G, ...) uint8 -> (T, ...) {0,1}
    planes inserted at ``time_axis``."""
    g = packed.shape[0]
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} timesteps")
    bits = (packed.unsqueeze(1) >> _shifts(packed, packed.ndim - 1)) & 1
    planes = bits.reshape(g * 8, *packed.shape[1:])[:t]
    return torch.movedim(planes.to(dtype), 0, time_axis)


def bitplanes_u8(x: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """uint8 tensor (...) -> (8, ...) binary planes, LSB first (SSSC input)."""
    return ((x.unsqueeze(0) >> _shifts(x, x.ndim)) & 1).to(dtype)


def packed_occupancy(packed, t: int) -> float:
    """Mean firing rate of a (G, ...) packed spike tensor over its ``t``
    live timesteps: set bits / (t * neurons). Dead bits are zero by the
    packing invariant, so a popcount over every byte is exact."""
    g = packed.shape[0]
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} timesteps")
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    x = np.asarray(packed, np.uint8)
    neurons = x.size // g if g else 0
    if not neurons:
        return 0.0
    return float(np.unpackbits(x.reshape(-1)).sum()) / (t * neurons)


def structured_spikes(generator: torch.Generator, *, t: int, shape: tuple,
                      rate: float, chunk: int = 8,
                      group_rate: float = 0.9) -> torch.Tensor:
    """Random packed spikes at firing rate ``rate`` with channel-structured
    sparsity, drawn from ``generator`` on its device: an exact count,
    ``max(1, round(rate / group_rate * groups))``, of the ``chunk``-aligned
    channel groups is active (shared across rows and timesteps) and only
    those fire, each active channel at ``rate * groups / n_active``.
    Returns ``(G, *shape)`` uint8 plane groups.

    The contract (the reference's, whose bits come from JAX's RNG): the
    active-group fraction is ``rate / group_rate``, so a K-chunk of 8
    channels is live only where its group is active and the CHUNK
    occupancy the sparse route's budget is sized from tracks the firing
    rate ~1:1 (iid bits at rate p leave almost no chunk all-zero). The
    last axis of ``shape`` is the channel axis, a multiple of ``chunk``;
    ``rate`` must not exceed ``group_rate``."""
    if not 0.0 <= rate <= group_rate <= 1.0:
        raise ValueError(f"need 0 <= rate <= group_rate <= 1, got "
                         f"{rate!r}, {group_rate!r}")
    *lead, channels = shape
    if channels % chunk:
        raise ValueError(f"{channels} channels are not whole {chunk}-chunks")
    dev = generator.device
    if rate == 0.0:
        return torch.zeros((num_plane_groups(t), *shape), dtype=torch.uint8,
                           device=dev)
    groups = channels // chunk
    n_active = max(1, round(rate / group_rate * groups))
    active = torch.zeros(groups, dtype=torch.bool, device=dev)
    active[torch.randperm(groups, generator=generator,
                          device=dev)[:n_active]] = True
    active = active.repeat_interleave(chunk)          # (channels,) mask
    p = min(1.0, rate * groups / n_active)
    bits = torch.rand((t, *lead, channels), generator=generator,
                      device=dev) < p
    return pack_timesteps(bits & active)


def rate_decode(spikes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Spike train -> rate (mean over timesteps); classification readout."""
    return spikes.to(torch.float32).mean(dim=axis)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/b, W/b, b*b*C): the ZSC zig-zag placement
    that turns a 2x2/s2 convolution into a plain matmul over 4C features."""
    *lead, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(*lead, h // block, block, w // block, block, c)
    x = torch.movedim(x, -4, -3)            # (..., H/b, W/b, b, b, C)
    return x.reshape(*lead, h // block, w // block, block * block * c)
