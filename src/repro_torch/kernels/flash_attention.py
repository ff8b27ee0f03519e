"""Flash attention: softmax attention streamed over KV tiles with an online
softmax (port of ``repro.kernels.flash_attention``).

``flash_attention`` takes grouped-query heads and strided operands and
dispatches on the operands' dtype: bf16 launches
``csrc/flash_attention_tc.cu`` (bf16 wgmma), f32 launches
``csrc/flash_attention.cu`` (split TF32 on wgmma); both load their tiles
by TMA and read each KV head and strided view in place. Each takes every
head dim from 1 up, as the reference's Pallas kernel does, in one launch:
up to Dh 256 a block holds all of Dh's output columns (the bf16 kernel in
64-column boxes, the f32 kernel at Dh 32 and 64 and at every multiple of
32 from 96 to 256, a Dh in between running the next one up: TMA
zero-fills the columns past Dh); past 256 the output columns are cut into
slices of at most 256 (bf16) or 128 (f32), a block a slice, each taking
S = Q K^T over the whole of Dh. TMA reads rows of a multiple of 16 bytes,
so a Dh that is not a multiple of 8 (bf16) or 4 (f32) is zero-padded to
one and the output cut back: zero columns add zero to every score and
every output, and the scale is passed as given. CPU operands run the
plain version, ``flash_attention_plain``. Each kernel's wrapper counts its
launches (a padded call is one launch)."""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)


def _grouped(q, k, v):
    """The operands as (B, Hq, Nq, Dh) and (B, KV, Nkv, Dh) views, checked:
    3-d (BH, N, Dh) operands are one batch of BH heads."""
    for name, z in (("q", q), ("k", k), ("v", v)):
        if z.dtype not in DTYPES or z.dtype != q.dtype:
            raise ValueError(f"{name} must be f32 or bf16 like q, got "
                             f"{z.dtype} (q {q.dtype})")
        if z.dim() not in (3, 4) or z.dim() != q.dim():
            raise ValueError(f"{name} must be 3-d (BH, N, Dh) or 4-d (B, H, "
                             f"N, Dh) like q, got {z.dim()}-d")
        if z.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in Dh")
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    b, hq, nq, dh = q.shape
    kvh, nkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != b or k.shape[3] != dh
            or kvh == 0 or hq % kvh):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (q heads a multiple of "
                         "KV heads)")
    if nkv == 0:
        raise ValueError("every query needs a key: Nkv=0")
    return q, k, v


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True):
    """The plain version: KV expanded to the q heads (``repeat_interleave``,
    the reference's ``jnp.repeat``) and ``ref.flash_attention_ref``.
    Shapes as ``flash_attention``."""
    q4, k4, v4 = _grouped(q, k, v)
    b, hq, nq, dh = q4.shape
    g = hq // k4.shape[1]
    k4, v4 = k4.repeat_interleave(g, dim=1), v4.repeat_interleave(g, dim=1)
    out = flash_attention_ref(q4.reshape(b * hq, nq, dh),
                              k4.reshape(b * hq, -1, dh),
                              v4.reshape(b * hq, -1, dh), scale=scale,
                              causal=causal)
    return out.reshape(q.shape[:-1] + (dh,))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Nq, Dh); k, v: (B, KV, Nkv, Dh), Hq a multiple of KV, q
    head h reading KV head ``h // (Hq // KV)``; or all three 3-d (BH, N,
    Dh). All f32 or all bf16, any strides with a unit last stride. Returns
    f32 of q's shape. Causal over absolute positions: query i sits at
    ``Nkv - Nq + i``, so causal calls need ``Nq <= Nkv`` (otherwise a row
    would see no key)."""
    q4, k4, v4 = _grouped(q, k, v)
    nq, nkv, dh = q4.shape[2], k4.shape[2], q4.shape[3]
    if causal and nq > nkv:
        raise ValueError(f"every query needs a key: Nq={nq}, Nkv={nkv}, "
                         f"causal={causal}")
    if _build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale=scale, causal=causal)
    if dh == 0:
        raise ValueError(f"the flash kernels take Dh >= 1, got "
                         f"{tuple(q.shape)}")
    fn = flash_attention_tc if q.dtype == torch.bfloat16 else \
        flash_attention_f32
    return fn(q4, k4, v4, scale=scale, causal=causal).reshape(
        q.shape[:-1] + (dh,))


def _tma_ready(z: torch.Tensor) -> torch.Tensor:
    """``z`` with the layout TMA takes: a 16-byte aligned base and every
    stride a positive multiple of 16 bytes; otherwise a contiguous copy."""
    step = 16 // z.element_size()
    ok = z.data_ptr() % 16 == 0 and all(
        s > 0 and s % step == 0
        for s, n in zip(z.stride()[:-1], z.shape[:-1]) if n > 1)
    return z if ok else z.contiguous()


def _strides(z: torch.Tensor) -> list:
    """(batch, head, row) element strides, those of size-1 dimensions
    replaced by a valid one (they multiply index 0 only)."""
    return [s if n > 1 else 8 * z.shape[-1]
            for s, n in zip(z.stride()[:3], z.shape[:3])]


def _launch(wrapper, name: str, symbol: str, q, k, v, *, scale: float,
            causal: bool):
    """Launch ``csrc/<name>.cu`` on (B, Hq, Nq, Dh) over (B, KV, Nkv, Dh),
    read in place (copied only where TMA cannot read a view; zero-padded
    to a Dh of whole 16-byte rows where it is not one) -> (B, Hq, Nq, Dh)
    f32; count the launch on ``wrapper``."""
    dh_given = q.shape[-1]
    pad = -dh_given % (16 // q.element_size())
    if pad:
        q, k, v = (torch.nn.functional.pad(z, (0, pad)) for z in (q, k, v))
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    if k.stride() != v.stride():
        k, v = k.contiguous(), v.contiguous()
    b, hq, nq, dh = q.shape
    kvh, nkv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, nq, dh), dtype=torch.float32, device=q.device)
    fn = _build.kernel_function(name, symbol, _ARGTYPES)
    _build.check(name, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, kvh,
        nq, nkv, dh, *_strides(q), *_strides(k), *_strides(v), scale,
        int(causal), _build.stream(q)))
    _build.count_launch(wrapper)
    return out[..., :dh_given] if pad else out


def flash_attention_tc(q, k, v, *, scale: float, causal: bool = True):
    """The bf16 tensor-core kernel on CUDA bf16 operands, (B, Hq, Nq, Dh)
    over (B, KV, Nkv, Dh), read in place -> (B, Hq, Nq, Dh) f32."""
    return _launch(flash_attention_tc, "flash_attention_tc",
                   "flash_attention_tc_launch", q, k, v, scale=scale,
                   causal=causal)


def flash_attention_f32(q, k, v, *, scale: float, causal: bool = True):
    """The split-TF32 tensor-core kernel on CUDA f32 operands, (B, Hq, Nq,
    Dh) over (B, KV, Nkv, Dh), read in place -> (B, Hq, Nq, Dh) f32."""
    return _launch(flash_attention_f32, "flash_attention",
                   "flash_attention_launch", q, k, v, scale=scale,
                   causal=causal)


flash_attention_tc.launches = 0
flash_attention_f32.launches = 0
