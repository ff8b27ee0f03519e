"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are the oracles the CUDA kernels are held against on the card, and
what the kernel wrappers run for tensors that lie on the CPU. They run on
any device.
"""
from __future__ import annotations

import torch

from ..core.spike import bitplanes_u8, num_plane_groups, unpack_timesteps
from ..device import constant


def spike_matmul_ref(x_packed: torch.Tensor, w: torch.Tensor, *,
                     t: int | None = None,
                     mode: str = "per_plane") -> torch.Tensor:
    """The unified-PE dot over packed bits.

    (G, M, K) uint8 plane groups ("per_plane" only) -> (t, M, N) f32, plane
    p = bit ``p % 8`` of group ``p // 8``; only the ``t`` live planes are
    computed (the reference's (G, 8, M, N) sliced to ``[:t]``, which is all
    ``ops.spike_linear`` keeps). ``t`` defaults to every plane, 8G.

    (M, K) uint8 -> (8, M, N) per-plane dots for ``mode="per_plane"``, or
    (M, N) for ``mode="shift_sum"``: the per-plane dots scaled by 2^p and
    summed, the byte read as a value (the reference's 2-D forms)."""
    if mode not in ("per_plane", "shift_sum"):
        raise ValueError(f"unknown spike_matmul mode {mode!r}")
    wf = w.to(torch.float32)
    if x_packed.dim() == 3:
        if mode != "per_plane":
            raise ValueError("plane groups are temporal: per_plane only")
        g, m, k = x_packed.shape
        t = 8 * g if t is None else t
        planes = unpack_timesteps(x_packed, t)             # (t, M, K)
        return (planes.reshape(t * m, k) @ wf).reshape(t, m, w.shape[-1])
    m, k = x_packed.shape
    planes = bitplanes_u8(x_packed)                        # (8, M, K)
    per_plane = (planes.reshape(8 * m, k) @ wf).reshape(8, m, w.shape[-1])
    if mode == "per_plane":
        return per_plane
    scales = (2.0 ** torch.arange(8, dtype=torch.float32,
                                  device=w.device)).reshape(8, 1, 1)
    return (per_plane * scales).sum(dim=0)


def tflif_ref(x: torch.Tensor, bias=None, *, tau: float = 2.0,
              v_th=1.0) -> torch.Tensor:
    """x: (T, ...) -> (G, ...) uint8 packed spikes, G = ceil(T/8); bit j of
    group g is the spike at timestep 8g+j, the membrane carried across
    group boundaries. ``bias`` and ``v_th`` broadcast against
    ``x.shape[1:]``. Same op order as the reference:
    ``v + ((x + bias) - v) / tau``, here one ``addcdiv`` (``v + 1 * (d /
    tau)``: the product by one is exact, so the sum rounds as the
    reference's). Step 0 charges from v = 0 as ``(x + bias) / tau``, which
    differs from ``0 + (x + bias - 0) / tau`` at most in a zero's sign,
    and no spike depends on that sign. Each step's spikes are added into
    their group's bit as they fire, and the reset writes into the step's
    fresh membrane (the last step's membrane is not needed): about five
    torch calls a step, which is what a CPU step pays for (a reduced
    model's step is about a thousand short calls)."""
    xb = x.to(torch.float32)
    if bias is not None:
        xb = xb + bias          # every step's x + bias at once
    t = xb.shape[0]
    out = torch.zeros((num_plane_groups(t), *xb.shape[1:]),
                      dtype=torch.uint8, device=x.device)
    groups = [out[g] for g in range(out.shape[0])]
    tau_t = constant(("tau_f32", float(tau)), x.device, lambda d: torch.tensor(
        float(tau), dtype=torch.float32, device=d))
    v = None
    for j, xj in enumerate(xb.unbind(0)):
        h = xj / tau_t if v is None else torch.addcdiv(v, xj - v, tau_t)
        s = h >= v_th
        groups[j // 8].add_(s, alpha=1 << (j % 8))
        if j + 1 < t:
            v = h.masked_fill_(s, 0.0)
    return out


def stdp_attention_ref(q, k, v, *, scale: float) -> torch.Tensor:
    """q, k, v: (BH, N, Dh) -> (Q K^T) V * scale."""
    s = torch.einsum("bnd,bmd->bnm", q.to(torch.float32), k.to(torch.float32))
    return torch.einsum("bnm,bmd->bnd", s, v.to(torch.float32)) * scale


def flash_attention_ref(q, k, v, *, scale: float,
                        causal: bool = True) -> torch.Tensor:
    """q: (BH, Nq, Dh); k, v: (BH, Nkv, Dh) -> (BH, Nq, Dh) f32. Exact
    softmax attention; causal over absolute positions, query i at
    ``Nkv - Nq + i``."""
    nq, nkv = q.shape[1], k.shape[1]
    s = torch.einsum("bnd,bmd->bnm", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        qpos = (nkv - nq) + torch.arange(nq, device=q.device)[:, None]
        kpos = torch.arange(nkv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnm,bmd->bnd", p, v.to(torch.float32))
