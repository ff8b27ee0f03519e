"""The unified PE's four dataflows as float ops (port of
``repro.core.unified``): the reference backend's arithmetic.

All four layer types reduce to one weight-stationary matmul over binary
planes, differing in where the planes come from and how they are reduced:

  WSSL  planes = T timesteps of spikes,   per-plane outputs
  ZSC   planes = T timesteps of spikes,   conv2x2/s2 == space-to-depth + WSSL
  SSSC  planes = 8 bit-planes of a uint8, outputs summed with scales 2^k
  STDP  planes = T timesteps,             (Q K^T) V, no softmax

Spikes are {0,1} f32 tensors with a leading T axis. The packed datapath
lives in ``repro_torch.kernels``.
"""
from __future__ import annotations

import torch

from .spike import bitplanes_u8, space_to_depth


def wssl(spikes, kernel, bias=None):
    """Weight-stationary spiking linear: (T, ..., D) x (D, F) ->
    (T, ..., F). T folds into the rows of one dot, so one weight fetch
    serves every timestep."""
    t, lead, d = spikes.shape[0], spikes.shape[1:-1], spikes.shape[-1]
    y = spikes.reshape(-1, d).to(torch.float32) @ kernel.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.reshape(t, *lead, kernel.shape[-1])


def zsc(spikes, kernel, bias=None):
    """Zig-zag spiking conv, 2x2/s2 over (T, B, H, W, C) spikes: the
    space-to-depth placement makes every output pixel one row of a
    T-fused matmul. ``kernel`` is (2, 2, C, F) or its (4C, F) flattening."""
    return wssl(space_to_depth(spikes, 2),
                kernel.reshape(-1, kernel.shape[-1]), bias)


def sssc(image_u8, kernel, bias=None):
    """Shift-and-sum spiking conv, 2x2/s2 over a (B, H, W, C) uint8 image:
    the 8 bit-planes run through the binary datapath and combine as
    ``y = sum_p 2^p (plane_p . W)``, an 8-bit conv's result."""
    x = space_to_depth(image_u8, 2)                     # (B,H/2,W/2,4C) u8
    planes = bitplanes_u8(x)                            # (8, B, H/2, W/2, 4C)
    per_plane = wssl(planes, kernel.reshape(-1, kernel.shape[-1]))
    scales = (2.0 ** torch.arange(8, dtype=torch.float32,
                                  device=per_plane.device)).reshape(
        (8,) + (1,) * (per_plane.dim() - 1))
    y = (per_plane * scales).sum(dim=0)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def stdp(q, k, v, *, scale: float):
    """Spiking tile-wise dot product, (Q K^T) V * scale over (T, B, H, N,
    Dh) spikes. K^T V comes first, as in the reference: an exactly
    equivalent association for spikes, which never forms the N x N
    scores."""
    qf, kf, vf = (z.to(torch.float32) for z in (q, k, v))
    ctx = torch.einsum("tbhnd,tbhnf->tbhdf", kf, vf)    # (T,B,H,Dh,Dh)
    return torch.einsum("tbhnd,tbhdf->tbhnf", qf, ctx) * scale
