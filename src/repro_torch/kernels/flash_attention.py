"""Flash attention: softmax attention streamed over KV tiles with an online
softmax (port of ``repro.kernels.flash_attention``). ``flash_attention``
launches ``csrc/flash_attention.cu`` for CUDA operands and runs
``ref.flash_attention_ref`` for CPU ones."""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]
HEAD_DIMS = (32, 64, 128)   # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535         # gridDim.y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """q: (BH, Nq, Dh); k, v: (BH, Nkv, Dh), all f32 or all bf16 ->
    (BH, Nq, Dh) f32. Causal over absolute positions: query i sits at
    ``Nkv - Nq + i``, so causal calls need ``Nq <= Nkv`` (otherwise a row
    would see no key)."""
    for name, z in (("q", q), ("k", k), ("v", v)):
        if z.dtype not in DTYPES or z.dtype != q.dtype:
            raise ValueError(f"{name} must be f32 or bf16 like q, got "
                             f"{z.dtype} (q {q.dtype})")
        _build.require(z, name, q.dtype, 3)
    bh, nq, dh = q.shape
    nkv = k.shape[1]
    if v.shape != k.shape or k.shape[0] != bh or k.shape[2] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if nkv == 0 or (causal and nq > nkv):
        raise ValueError(f"every query needs a key: Nq={nq}, Nkv={nkv}, "
                         f"causal={causal}")
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    if dh not in HEAD_DIMS or bh > _GRID_LIMIT:
        raise ValueError(f"the flash kernel takes Dh in {HEAD_DIMS} and at "
                         f"most {_GRID_LIMIT} batch-heads, got "
                         f"{tuple(q.shape)}")
    out = torch.empty((bh, nq, dh), dtype=torch.float32, device=q.device)
    fn = _build.kernel_function("flash_attention", "flash_attention_launch",
                                _ARGTYPES)
    _build.check("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, nq,
        nkv, dh, int(q.dtype == torch.bfloat16), scale, int(causal),
        _build.stream(q)))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
