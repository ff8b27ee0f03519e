"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are the oracles the CUDA kernels are held against on the card, and
what the kernel wrappers run for tensors that lie on the CPU. They run on
any device.
"""
from __future__ import annotations

import torch

from ..core.spike import num_plane_groups, unpack_timesteps


def spike_matmul_ref(x_packed: torch.Tensor, w: torch.Tensor, *,
                     t: int) -> torch.Tensor:
    """Grouped per-plane dot: (G, M, K) uint8 plane groups x (K, N) ->
    (t, M, N) f32, plane p = bit ``p % 8`` of group ``p // 8``. Only the
    ``t`` live planes are computed (the reference's (G, 8, M, N) sliced to
    ``[:t]``, which is all ``ops.spike_linear`` keeps)."""
    g, m, k = x_packed.shape
    planes = unpack_timesteps(x_packed, t)                 # (t, M, K)
    y = planes.reshape(t * m, k) @ w.to(torch.float32)
    return y.reshape(t, m, w.shape[-1])


def tflif_ref(x: torch.Tensor, bias=None, *, tau: float = 2.0,
              v_th=1.0) -> torch.Tensor:
    """x: (T, ...) -> (G, ...) uint8 packed spikes, G = ceil(T/8); bit j of
    group g is the spike at timestep 8g+j, the membrane carried across
    group boundaries. ``bias`` and ``v_th`` broadcast against
    ``x.shape[1:]``. Same op order as the reference:
    ``v + ((x + bias) - v) / tau``."""
    t_steps = x.shape[0]
    lead = x.shape[1:]
    if bias is None:
        bias = 0.0
    v_th = torch.as_tensor(v_th, dtype=torch.float32, device=x.device)
    v = torch.zeros(lead, dtype=torch.float32, device=x.device)
    out = []
    for g in range(num_plane_groups(t_steps)):
        packed = torch.zeros(lead, dtype=torch.uint8, device=x.device)
        for j in range(min(8, t_steps - 8 * g)):
            h = v + (x[8 * g + j].to(torch.float32) + bias - v) / tau
            s = h >= v_th
            v = torch.where(s, 0.0, h)
            packed = packed | (s.to(torch.uint8) << j)
        out.append(packed)
    return torch.stack(out)


def stdp_attention_ref(q, k, v, *, scale: float) -> torch.Tensor:
    """q, k, v: (BH, N, Dh) -> (Q K^T) V * scale."""
    s = torch.einsum("bnd,bmd->bnm", q.to(torch.float32), k.to(torch.float32))
    return torch.einsum("bnm,bmd->bnd", s, v.to(torch.float32)) * scale
