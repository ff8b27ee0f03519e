"""Fused TFLIF -> pack -> byte-LUT matmul over a producer/consumer linear
pair, the MLP's fc1 -> fc2 step (port of ``repro.kernels.fused``).

``tflif_lut_matmul`` launches ``csrc/fused_lif_lut.cu`` for CUDA operands
and runs ``tflif_lut_plain`` for CPU ones. The fc1 spikes never exist
unpacked outside registers: the kernel builds fc2's LUT index bytes
straight from the spike bits, so the 8x8 bit transpose of the unfused route
(``lut_matmul.plane_indices``) is never run.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lut_matmul import lut_matmul, num_k_chunks, plane_indices
from .ref import tflif_ref
from ..core.lif import TAU
from ..core.spike import num_plane_groups

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
MAX_T = 64                # csrc/fused_lif_lut.cu's register budget per thread
_GRID_LIMIT = 65535       # gridDim.y: row tiles


def _rows_per_block(t: int) -> int:
    """Rows a block of the kernel owns: 1024 / TT, TT the power of two
    (4 to 64) that holds t steps."""
    return 1024 // max(4, 1 << (t - 1).bit_length())


def fused_fits(t: int, r: int) -> bool:
    """Whether the kernel takes T = ``t`` steps over ``r`` rows: T <= MAX_T
    (its registers hold every step) and at most ``_GRID_LIMIT`` row tiles.
    The wrapper refuses anything else on the card; ``mlp_pair_lif`` then
    runs the two layers instead, which is bit-identical."""
    return 1 <= t <= MAX_T and -(-r // _rows_per_block(t)) <= _GRID_LIMIT


def tflif_lut_plain(x: torch.Tensor, bias: torch.Tensor, table: torch.Tensor,
                    v_th: torch.Tensor, *, tau: float = TAU):
    """Plain version of ``tflif_lut_matmul``, on any device: the
    composition the reference's CPU branch of ``ops.tflif_lut`` runs,
    TFLIF, then ``plane_indices``, then ``lut_matmul``."""
    spikes = tflif_ref(x, bias, tau=tau, v_th=v_th)         # (G, R, K)
    idx = plane_indices(spikes)[:x.shape[0]]                # (T, R, C)
    return spikes, lut_matmul(idx, table)


def tflif_lut_matmul(x: torch.Tensor, bias: torch.Tensor, table: torch.Tensor,
                     v_th: torch.Tensor, *, tau: float = TAU):
    """x: (T, R, K) f32 producer accumulators (producer bias not added);
    bias, v_th: (K,) f32; table: (C, 256, N) int16 or f32 consumer table,
    C = ceil(K/8). Returns ``(spikes, acc)``: spikes (G, R, K) uint8, the
    producer's packed LIF output, and acc (T, R, N) f32, the consumer's
    pre-LIF accumulators by the ascending-chunk fold (int32 for int16
    tables). Both bit-exact against ``tflif_lut_plain``."""
    _build.require(x, "x", torch.float32, 3)
    _build.require(bias, "bias", torch.float32, 1)
    _build.require(v_th, "v_th", torch.float32, 1)
    if table.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"table must be int16 or float32, got {table.dtype}")
    _build.require(table, "table", table.dtype, 3)
    t, r, k = x.shape
    if bias.shape != (k,) or v_th.shape != (k,):
        raise ValueError(f"bias {tuple(bias.shape)} and v_th "
                         f"{tuple(v_th.shape)} must both be ({k},)")
    if table.shape[0] != num_k_chunks(k) or table.shape[1] != 256:
        raise ValueError(f"x {tuple(x.shape)} does not match table "
                         f"{tuple(table.shape)}")
    n = table.shape[2]
    if _build.on_cpu(x, bias, table, v_th):
        return tflif_lut_plain(x, bias, table, v_th, tau=tau)
    if not fused_fits(t, r):
        raise ValueError(f"fused kernel takes T <= {MAX_T} and at most "
                         f"{_GRID_LIMIT} row tiles, got T={t}, R={r}")
    spikes = torch.empty((num_plane_groups(t), r, k), dtype=torch.uint8,
                         device=x.device)
    acc = torch.empty((t, r, n), dtype=torch.float32, device=x.device)
    symbol = ("fused_lif_lut_i16" if table.dtype == torch.int16
              else "fused_lif_lut_f32")
    fn = _build.kernel_function("fused_lif_lut", symbol, _ARGTYPES)
    _build.check("fused_lif_lut", fn(
        x.data_ptr(), bias.data_ptr(), v_th.data_ptr(), table.data_ptr(),
        spikes.data_ptr(), acc.data_ptr(), t, r, k, n, tau,
        _build.stream(x)))
    _build.count_launch(tflif_lut_matmul)
    return spikes, acc


tflif_lut_matmul.launches = 0
