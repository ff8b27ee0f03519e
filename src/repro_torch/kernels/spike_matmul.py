"""Unified-PE matmuls over packed spikes: the byte-LUT gather, the
grouped unpack dot and the 2-D ``spike_matmul`` (port of
``repro.kernels.spike_matmul``).

``lut_gather_matmul`` launches ``csrc/lut_gather.cu`` over index bytes
(plain version: ``lut_matmul.lut_matmul``) and ``lut_gather_packed`` the
same kernel over packed spikes, forming the index bytes on chip (plain
version: ``lut_gather_packed_plain``); ``spike_matmul_grouped`` launches
``csrc/unpack_dot.cu`` (f32 weights as the three-term bf16 split
``bf16x3_weights`` builds, the bf16 tensor cores),
``spike_matmul_grouped_s8`` launches ``csrc/unpack_dot_s8.cu`` (int8
weights in the K-major layout ``kmajor_weights`` builds, the int8 tensor
cores) and ``shift_sum_matmul`` launches ``csrc/shift_sum.cu`` (plain
versions: ``ref.spike_matmul_ref``). Each runs its plain version for CPU
operands. ``spike_matmul`` is the
reference's 2-D entry point: ``mode="shift_sum"`` is ``shift_sum_matmul``,
``mode="per_plane"`` the grouped unpack dot at G=1 over all 8 planes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lut_matmul import lut_matmul, num_k_chunks, plane_indices
from .ref import spike_matmul_ref
from ..core.spike import num_plane_groups

_LUT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p]
_LUT_PACKED_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
_UNPACK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_UNPACK_S8_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
_SHIFT_SUM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
_GRID_LIMIT = 65535       # gridDim.y / gridDim.z
# int8 sums are exact in s32 and in their f32 conversion while
# 127 * K < 2^24
MAX_S8_K = 132104
_ROW_ALIGN = 16           # bytes: TMA's row stride and base alignment
_BF16_ROW = _ROW_ALIGN // 2   # bf16 elements in 16 bytes


def _lut_table(table: torch.Tensor) -> None:
    if table.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"table must be int16 or float32, got {table.dtype}")
    _build.require(table, "table", table.dtype, 3)
    if table.shape[1] != 256:
        raise ValueError(f"table {tuple(table.shape)} is not (C, 256, N)")


def _lut_launch(symbol: str, argtypes, table: torch.Tensor,
                src: torch.Tensor, shape, *dims) -> torch.Tensor:
    """Launch one entry of ``csrc/lut_gather.cu`` (sizes are C ints);
    both entries count as ``lut_gather_matmul.launches``."""
    if max(shape) >= 2 ** 31:
        raise ValueError(f"gather of shape {shape} exceeds the kernel's "
                         "32-bit sizes")
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    suffix = "i16" if table.dtype == torch.int16 else "f32"
    fn = _build.kernel_function("lut_gather", f"{symbol}_{suffix}", argtypes)
    _build.check("lut_gather", fn(src.data_ptr(), table.data_ptr(),
                                  out.data_ptr(), *dims,
                                  _build.stream(src)))
    _build.count_launch(lut_gather_matmul)
    return out


def lut_gather_matmul(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, M, C) uint8 per-plane index bytes x (C, 256, N) int16 or f32
    table -> (P, M, N) f32 by the ascending-chunk fold (int32 accumulation
    for int16 tables). Bit-exact against ``lut_matmul``."""
    _build.require(idx, "idx", torch.uint8, 3)
    _lut_table(table)
    p, m, c = idx.shape
    if table.shape[0] != c:
        raise ValueError(f"index bytes {tuple(idx.shape)} do not match table "
                         f"{tuple(table.shape)}")
    if _build.on_cpu(idx, table):
        return lut_matmul(idx, table)
    n = table.shape[2]
    return _lut_launch("lut_gather", _LUT_ARGTYPES, table, idx, (p, m, n),
                       p, m, c, n)


def lut_gather_packed_plain(x_packed: torch.Tensor, table: torch.Tensor, *,
                            t: int) -> torch.Tensor:
    """Plain version of ``lut_gather_packed``, on any device: the 8x8 bit
    transpose in torch (``plane_indices``), then ``lut_matmul``."""
    return lut_matmul(plane_indices(x_packed)[:t], table)


def lut_gather_packed(x_packed: torch.Tensor, table: torch.Tensor, *,
                      t: int) -> torch.Tensor:
    """(G, M, K) uint8 packed spikes (plane p = bit ``p % 8`` of group
    ``p // 8``; for SSSC, G = 1 and the 8 value bits of a byte) x
    (ceil(K/8), 256, N) int16 or f32 table -> (t, M, N) f32: the gather of
    ``lut_gather_matmul`` over the index bytes ``plane_indices`` would
    form, formed inside the kernel. Bit-exact against
    ``lut_gather_packed_plain``; launches count as
    ``lut_gather_matmul.launches``."""
    _build.require(x_packed, "x_packed", torch.uint8, 3)
    _lut_table(table)
    g, m, k = x_packed.shape
    if table.shape[0] != num_k_chunks(k):
        raise ValueError(f"x {tuple(x_packed.shape)} does not match table "
                         f"{tuple(table.shape)}")
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} planes")
    if _build.on_cpu(x_packed, table):
        return lut_gather_packed_plain(x_packed, table, t=t)
    n = table.shape[2]
    return _lut_launch("lut_gather_packed", _LUT_PACKED_ARGTYPES, table,
                       x_packed, (t, m, n), t, g, m, k, n)


def bf16x3_weights(w: torch.Tensor, *, name: str = "w") -> torch.Tensor:
    """(K, N) f32 kernel -> its (3, N, K) bf16 K-major split, the B operand
    of the f32 unpack dot on the bf16 tensor cores: ``hi = bf16(w)``,
    ``mid = bf16(w - hi)``, ``lo = bf16(w - hi - mid)``, each equal to its
    term's transpose, rows 16 bytes apart (a view of zero-padded (3, N,
    ceil(K/8)*8) storage), as TMA needs. Raises, naming ``name``, unless
    ``hi + mid + lo == w`` for every weight (three 8-bit significands
    cover f32's 24 while ``lo`` stays a normal bf16: |w| >= ~2^-110, or
    0). The check reads one flag to the host, so a plan builds the split
    once per layer and a captured step never builds it."""
    if w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError(f"{name} must be a 2-d torch.float32 kernel, got "
                         f"{w.dim()}-d {w.dtype}")
    k, n = w.shape
    hi = w.to(torch.bfloat16)
    rest = w - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.to(torch.float32)).to(torch.bfloat16)
    back = (hi.to(torch.float32) + mid.to(torch.float32)) + lo.to(
        torch.float32)
    if not torch.equal(back, w):
        bad = int((back != w).sum())
        raise ValueError(f"{name}: {bad} f32 weights are not the sum of "
                         "their three bf16 terms (|w| below ~2^-110, or not "
                         "finite); the f32 unpack dot cannot hold them")
    pad = -(-k // _BF16_ROW) * _BF16_ROW
    split = torch.zeros((3, n, pad), dtype=torch.bfloat16, device=w.device)
    for q, term in enumerate((hi, mid, lo)):
        split[q, :, :k] = term.T
    return split[:, :, :k]


def _bf16x3_operand(w3: torch.Tensor, k: int, n: int) -> None:
    """Raise unless ``w3`` is a (3, N, K) bf16 split the kernel can read:
    unit K stride, rows and terms 16 bytes apart, base 16-byte aligned."""
    if w3.dtype != torch.bfloat16 or w3.dim() != 3:
        raise ValueError(f"w_bf16x3 must be a 3-d torch.bfloat16 tensor, got "
                         f"{w3.dim()}-d {w3.dtype}: build it with "
                         "bf16x3_weights")
    if tuple(w3.shape) != (3, n, k):
        raise ValueError(f"w_bf16x3 {tuple(w3.shape)} is not the (3, {n}, "
                         f"{k}) split of the weights")
    ldt, ldw, unit = w3.stride()
    if (unit != 1 or ldw % _BF16_ROW or ldt % _BF16_ROW or ldw < k
            or ldt < n * ldw or w3.data_ptr() % _ROW_ALIGN):
        raise ValueError("w_bf16x3 needs a unit K stride and rows and terms "
                         "16 bytes apart: build it with bf16x3_weights")


def spike_matmul_grouped(x_packed: torch.Tensor, w: torch.Tensor, *,
                         t: int, w_bf16x3: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(G, M, K) uint8 plane groups x (K, N) f32 -> (t, M, N) f32 per-plane
    dots, plane p = bit ``p % 8`` of group ``p // 8``; only the t live
    planes are computed. On the card the kernel reads ``w_bf16x3``, the
    weights' three-term bf16 split (``bf16x3_weights``, which the planner
    builds once per layer); without it the wrapper builds the split for
    this call (counted in ``spike_matmul_grouped.split_builds``). Exact for
    integer-valued weights of |w| <= 256; other f32 weights differ from
    other summation orders by rounding."""
    _build.require(x_packed, "x_packed", torch.uint8, 3)
    _build.require(w, "w", torch.float32, 2)
    g, m, k = x_packed.shape
    if w.shape[0] != k:
        raise ValueError(f"x {tuple(x_packed.shape)} and w {tuple(w.shape)} "
                         "disagree on K")
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} planes")
    n = w.shape[1]
    if _build.on_cpu(x_packed, w):
        return spike_matmul_ref(x_packed, w, t=t)
    if w_bf16x3 is None:
        w_bf16x3 = bf16x3_weights(w)
        _build.add_count(spike_matmul_grouped, "split_builds")
    else:
        _build.on_cpu(x_packed, w_bf16x3)         # one device, or raise
        _bf16x3_operand(w_bf16x3, k, n)
    if -(-m // (128 // min(t, 8))) > _GRID_LIMIT:
        raise ValueError(f"{m} rows exceed the launch grid")
    out = torch.empty((t, m, n), dtype=torch.float32, device=w.device)
    fn = _build.kernel_function("unpack_dot", "unpack_dot_launch",
                                _UNPACK_ARGTYPES)
    _build.check("unpack_dot", fn(
        x_packed.data_ptr(), w_bf16x3.data_ptr(), out.data_ptr(), t, m, k, n,
        w_bf16x3.stride(1), w_bf16x3.stride(0), _build.stream(x_packed)))
    _build.count_launch(spike_matmul_grouped)
    return out


def kmajor_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 kernel -> its (N, K) K-major copy, the B operand of the
    int8 tensor-core dot. Equal to ``w.T``; its rows start 16 bytes apart
    (a view of zero-padded (N, ceil(K/16)*16) storage), as TMA needs.
    Built once per layer at plan time, never per call."""
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"w must be a 2-d torch.int8 kernel, got "
                         f"{w.dim()}-d {w.dtype}")
    k, n = w.shape
    pad = -(-k // _ROW_ALIGN) * _ROW_ALIGN
    kt = torch.zeros((n, pad), dtype=torch.int8, device=w.device)
    kt[:, :k] = w.T
    return kt[:, :k]


def spike_matmul_grouped_s8(x_packed: torch.Tensor, w_kmajor: torch.Tensor,
                            *, t: int) -> torch.Tensor:
    """(G, M, K) uint8 plane groups x (N, K) int8 K-major weights (from
    ``kmajor_weights``) -> (t, M, N) f32 per-plane dots, plane p = bit
    ``p % 8`` of group ``p // 8``. Bit-exact against the plain version,
    ``spike_matmul_ref`` on ``w_kmajor.T`` in f32: every sum is an integer
    below 2^24, so K must stay below ``MAX_S8_K``."""
    _build.require(x_packed, "x_packed", torch.uint8, 3)
    if w_kmajor.dtype != torch.int8 or w_kmajor.dim() != 2:
        raise ValueError(f"w_kmajor must be a 2-d torch.int8 tensor, got "
                         f"{w_kmajor.dim()}-d {w_kmajor.dtype}: f32 weights "
                         "take spike_matmul_grouped")
    g, m, k = x_packed.shape
    n = w_kmajor.shape[0]
    if w_kmajor.shape[1] != k:
        raise ValueError(f"x {tuple(x_packed.shape)} and K-major w "
                         f"{tuple(w_kmajor.shape)} disagree on K")
    if k >= MAX_S8_K:
        raise ValueError(f"int8 sums are exact only for K < {MAX_S8_K}, "
                         f"got K={k}")
    if g != num_plane_groups(t):
        raise ValueError(f"{g} plane groups cannot hold t={t} planes")
    if _build.on_cpu(x_packed, w_kmajor):
        return spike_matmul_ref(x_packed, w_kmajor.T, t=t)
    if (w_kmajor.stride(1) != 1 or w_kmajor.stride(0) % _ROW_ALIGN
            or w_kmajor.data_ptr() % _ROW_ALIGN):
        raise ValueError("w_kmajor needs a unit column stride and rows 16 "
                         "bytes apart: build it with kmajor_weights")
    if -(-m // (128 // min(t, 8))) > _GRID_LIMIT:
        raise ValueError(f"{m} rows exceed the launch grid")
    out = torch.empty((t, m, n), dtype=torch.float32, device=x_packed.device)
    fn = _build.kernel_function("unpack_dot_s8", "unpack_dot_s8_launch",
                                _UNPACK_S8_ARGTYPES)
    _build.check("unpack_dot_s8", fn(
        x_packed.data_ptr(), w_kmajor.data_ptr(), out.data_ptr(), t, m, k, n,
        w_kmajor.stride(0), _build.stream(x_packed)))
    _build.count_launch(spike_matmul_grouped_s8)
    return out


def shift_sum_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) uint8 x (K, N) f32 -> (M, N) f32 with each byte read as its
    value: ``sum_p 2^p (plane_p . W)`` in one dot. Exact for
    integer-valued weights (sums below 2^24); f32 weights differ from the
    plain version's per-plane sum by rounding."""
    _build.require(x, "x", torch.uint8, 2)
    _build.require(w, "w", torch.float32, 2)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "disagree on K")
    n = w.shape[1]
    if _build.on_cpu(x, w):
        return spike_matmul_ref(x, w, mode="shift_sum")
    if -(-n // 64) > _GRID_LIMIT:
        raise ValueError(f"{n} columns exceed the launch grid")
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    fn = _build.kernel_function("shift_sum", "shift_sum_launch",
                                _SHIFT_SUM_ARGTYPES)
    _build.check("shift_sum", fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 m, k, n, _build.stream(w)))
    _build.count_launch(shift_sum_matmul)
    return out


def spike_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 mode: str = "per_plane") -> torch.Tensor:
    """The reference's 2-D unified-PE dot: (M, K) uint8, bit p of a byte
    = plane p, x (K, N) f32. ``mode="per_plane"`` -> (8, M, N), one dot
    per plane (the grouped unpack dot kernel at G=1, t=8);
    ``mode="shift_sum"`` -> (M, N), the byte read as a value (the
    shift-sum kernel)."""
    if mode == "shift_sum":
        return shift_sum_matmul(x, w)
    if mode != "per_plane":
        raise ValueError(f"unknown spike_matmul mode {mode!r}")
    _build.require(x, "x", torch.uint8, 2)
    return spike_matmul_grouped(x[None], w, t=8)


lut_gather_matmul.launches = 0
spike_matmul_grouped.launches = 0
spike_matmul_grouped.split_builds = 0
spike_matmul_grouped_s8.launches = 0
shift_sum_matmul.launches = 0
