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
