"""STDP: softmax-free spiking attention (Q K^T) V * scale (port of
``repro.kernels.stdp_attention``). Launches ``csrc/stdp.cu`` for CUDA
operands and runs ``ref.stdp_attention_ref`` for CPU ones."""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import stdp_attention_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
MAX_DH = 128              # csrc/stdp.cu's register budget per thread
_GRID_LIMIT = 65535       # gridDim.y


def stdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float) -> torch.Tensor:
    """q, k, v: (BH, N, Dh) f32 -> (BH, N, Dh) f32. Exact for spike
    operands (integer sums, power-of-two scale)."""
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
    stdp_attention.launches += 1
    return out


stdp_attention.launches = 0
