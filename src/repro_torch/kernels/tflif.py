"""TFLIF: bias add + LIF over T timesteps, emitting packed spikes.

Port of ``repro.kernels.tflif.tflif_fused``; the CUDA kernel is
``csrc/tflif.cu``. ``tflif_fused`` launches it for CUDA operands and runs
``tflif_plain`` for CPU ones.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import tflif_ref
from ..core.lif import TAU
from ..core.spike import num_plane_groups

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
             ctypes.c_void_p]
_MAX_PERIOD = 1 << 31     # csrc/tflif.cu's 32-bit channel index


def tflif_plain(x: torch.Tensor, bias: torch.Tensor, v_th: torch.Tensor, *,
                tau: float = TAU) -> torch.Tensor:
    """Plain version of ``tflif_fused``, on any device."""
    t, m = x.shape
    # the neurons as (m / period, period): bias and v_th broadcast over
    # the rows instead of being tiled out to all m neurons (one value
    # broadcasts as it is)
    period = math.lcm(bias.numel(), v_th.numel())

    def tiled(v):
        return (v if v.numel() in (1, period)
                else v.repeat(period // v.numel()))

    out = tflif_ref(x.reshape(t, m // period, period), tiled(bias), tau=tau,
                    v_th=tiled(v_th))
    return out.reshape(out.shape[0], m)


def tflif_fused(x: torch.Tensor, bias: torch.Tensor, v_th: torch.Tensor, *,
                tau: float = TAU) -> torch.Tensor:
    """x: (T, M) f32 accumulators with a unit neuron stride and any step
    stride (0 included: one row read for every step, as an ``expand``
    over T gives); bias, v_th: f32 vectors whose lengths divide M, neuron
    i reading entry ``i % len`` (a per-channel vector over a channels-last
    layout, or one value). Returns (ceil(T/8), M) uint8 with bit j of
    group g = the spike at step 8g+j."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be a 2-d torch.float32 tensor, got "
                         f"{x.dim()}-d {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("x must have a unit neuron stride")
    _build.require(bias, "bias", torch.float32, 1)
    _build.require(v_th, "v_th", torch.float32, 1)
    t, m = x.shape
    for name, v in (("bias", bias), ("v_th", v_th)):
        if v.numel() == 0 or m % v.numel() or v.numel() >= _MAX_PERIOD:
            raise ValueError(f"{name} of length {v.numel()} does not tile "
                             f"{m} neurons")
    if _build.on_cpu(x, bias, v_th):
        return tflif_plain(x, bias, v_th, tau=tau)
    out = torch.empty((num_plane_groups(t), m), dtype=torch.uint8,
                      device=x.device)
    fn = _build.kernel_function("tflif", "tflif_launch", _ARGTYPES)
    _build.check("tflif", fn(x.data_ptr(), x.stride(0) if t > 1 else 0,
                             bias.data_ptr(), bias.numel(), v_th.data_ptr(),
                             v_th.numel(), out.data_ptr(), t, m, tau,
                             _build.stream(x)))
    _build.count_launch(tflif_fused)
    return out


tflif_fused.launches = 0
