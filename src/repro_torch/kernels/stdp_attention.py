"""STDP: softmax-free spiking attention (Q K^T) V * scale (port of
``repro.kernels.stdp_attention``).

``stdp_attention`` takes f32 operands of any value and launches
``csrc/stdp.cu``, which multiplies on the tensor cores in split TF32
(``csrc/tf32x3.cuh``). ``stdp_attention_packed`` takes the
spikes as uint8 temporal plane groups, as the packed datapath keeps them,
and launches ``csrc/stdp_packed.cu``, which extracts each plane's bits into
fp16 tiles and multiplies on the tensor cores. CPU operands run the plain
versions, ``ref.stdp_attention_ref`` and ``stdp_attention_packed_plain``."""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import stdp_attention_ref
from ..core.spike import num_plane_groups, unpack_timesteps

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
_PACKED_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
MAX_DH = 128              # csrc/stdp.cu's register budget per thread
# the split-TF32 kernel against any f32 order of the sums, on real values:
# |got - want| <= STDP_F32_TOL * ((|Q| |K|^T) |V|) * scale elementwise; the
# split keeps each product within ~2^-21 of the f32 one (spikes: exact)
STDP_F32_TOL = 2.0 ** -20
_GRID_LIMIT = 65535       # gridDim.y
# the packed kernel's exactness: a score (<= Dh) is exact in fp16 up to
# 2048, and every f32 sum stays an integer below N * Dh < 2^24
MAX_PACKED_DH = 2048
MAX_PACKED_ELEMS = 2 ** 24


def stdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float) -> torch.Tensor:
    """q, k, v: (BH, N, Dh) f32 -> (BH, N, Dh) f32. Exact for spike
    operands (integer sums, power-of-two scale); within ``STDP_F32_TOL``
    of the f32 sums on real values."""
    for name, z in (("q", q), ("k", k), ("v", v)):
        _build.require(z, name, torch.float32, 3)
        if z.shape != q.shape:
            raise ValueError(f"{name} {tuple(z.shape)} does not match q "
                             f"{tuple(q.shape)}")
    bh, n, dh = q.shape
    if _build.on_cpu(q, k, v):
        return stdp_attention_ref(q, k, v, scale=scale)
    if not 1 <= dh <= MAX_DH or bh > _GRID_LIMIT:
        raise ValueError(f"STDP kernel takes 1 <= Dh <= {MAX_DH} and at most "
                         f"{_GRID_LIMIT} batch-heads, got {tuple(q.shape)}")
    out = torch.empty_like(q)
    fn = _build.kernel_function("stdp", "stdp_launch", _ARGTYPES)
    _build.check("stdp", fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), bh, n, dh, scale,
                            _build.stream(q)))
    _build.count_launch(stdp_attention)
    return out


def stdp_attention_packed_plain(q, k, v, *, t: int, scale: float):
    """The plain version of ``stdp_attention_packed``: unpack the t planes
    to f32, fold them into the batch-heads axis, ``stdp_attention_ref``."""
    lead = q.shape[1:-2]
    n, dh = q.shape[-2:]

    def unfold(z):
        planes = unpack_timesteps(z.reshape(z.shape[0], -1, n, dh), t)
        return planes.reshape(-1, n, dh)                 # (t*BH, N, Dh)

    out = stdp_attention_ref(unfold(q), unfold(k), unfold(v), scale=scale)
    return out.reshape(t, *lead, n, dh)


def stdp_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, t: int, scale: float) -> torch.Tensor:
    """q, k, v: (G, ..., N, Dh) uint8 temporal plane groups, G = ceil(t/8),
    plane s = bit ``s % 8`` of group ``s // 8``, any strides with a unit
    last stride -> (t, ..., N, Dh) f32: per plane, (Q K^T) V * scale.
    Bit-exact against the plain version: spikes are {0,1}, every sum an
    integer; the wrapper refuses ``N * Dh >= 2^24`` and ``Dh > 2048``,
    where that would no longer hold."""
    for name, z in (("q", q), ("k", k), ("v", v)):
        if z.dtype != torch.uint8 or z.dim() < 3:
            raise ValueError(f"{name} must be (G, ..., N, Dh) uint8 plane "
                             f"groups, got {z.dim()}-d {z.dtype}")
        if z.shape != q.shape:
            raise ValueError(f"{name} {tuple(z.shape)} does not match q "
                             f"{tuple(q.shape)}")
    g, lead, (n, dh) = q.shape[0], q.shape[1:-2], q.shape[-2:]
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} timesteps")
    if dh > MAX_PACKED_DH or n * dh >= MAX_PACKED_ELEMS:
        raise ValueError(f"packed STDP is exact only for Dh <= "
                         f"{MAX_PACKED_DH} and N * Dh < 2^24, got N={n}, "
                         f"Dh={dh}")
    if _build.on_cpu(q, k, v):
        return stdp_attention_packed_plain(q, k, v, t=t, scale=scale)
    heads = lead[-1] if lead else 1
    q5, k5, v5 = (z.reshape(g, -1, heads, n, dh) for z in (q, k, v))
    if q5.stride(-1) != 1 or not q5.stride() == k5.stride() == v5.stride():
        q5, k5, v5 = q5.contiguous(), k5.contiguous(), v5.contiguous()
    batch = q5.shape[1]
    # strides of size-1 dimensions multiply index 0 only: pass 0
    sg, sb, sh, sn = (s if size > 1 else 0
                      for s, size in zip(q5.stride()[:4], q5.shape[:4]))
    out = torch.empty((t, batch, heads, n, dh), dtype=torch.float32,
                      device=q.device)
    fn = _build.kernel_function("stdp_packed", "stdp_packed_launch",
                                _PACKED_ARGTYPES)
    _build.check("stdp_packed", fn(
        q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), out.data_ptr(), t, batch,
        heads, n, dh, sg, sb, sh, sn, scale,
        _build.stream(q)))
    _build.count_launch(stdp_attention_packed)
    return out.reshape(t, *lead, n, dh)


stdp_attention.launches = 0
stdp_attention_packed.launches = 0
