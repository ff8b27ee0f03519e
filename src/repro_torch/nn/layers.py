"""Common layers: linear, embedding, norms, rotary embeddings and the
token cross-entropy (port of ``repro.nn.layers``; M-RoPE is not ported
yet).

Pure functions over nested-dict params; the compute dtype is the caller's
and params keep the dtype they were made in. The large products are
``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import KeyStream, lecun_normal, trunc_normal

# ---------------------------------------------------------------------------
# Linear / Embedding
# ---------------------------------------------------------------------------


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, std: float | None = None):
    ks = KeyStream(gen)
    if std is None:
        kernel = lecun_normal(ks(), (d_in, d_out), fan_in=d_in, dtype=dtype)
    else:
        kernel = trunc_normal(ks(), (d_in, d_out), std=std, dtype=dtype)
    p = {"kernel": kernel}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=kernel.device)
    return p


def linear(p, x, *, compute_dtype=None):
    w = p["kernel"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def embedding_init(gen, vocab: int, d_model: int, *, dtype=torch.float32):
    return {"embedding": trunc_normal(gen, (vocab, d_model), std=0.02,
                                      dtype=dtype)}


def embed(p, ids, *, compute_dtype=None):
    """Rows of the table, cast after the gather (the reference casts the
    whole table first; the values are the same)."""
    rows = p["embedding"][ids]
    return rows if compute_dtype is None else rows.to(compute_dtype)


def unembed(p, x):
    """Tied LM head: logits in f32 for a stable softmax."""
    return x.to(torch.float32) @ p["embedding"].to(torch.float32).T


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, *, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               rotary_frac: float = 1.0, device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * rotary_frac) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, *, theta: float = 10000.0,
               rotary_frac: float = 1.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    inv, rot = rope_freqs(x.shape[-1], theta=theta, rotary_frac=rotary_frac,
                          device=x.device)
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def swiglu(gate, up):
    return F.silu(gate) * up


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softmax_xent(logits, labels, *, ignore_id: int = -100):
    """Mean token cross-entropy in f32; labels == ``ignore_id`` are
    masked out, and the sum is divided by the count of the others (at
    least 1)."""
    logits = logits.to(torch.float32)
    mask = labels != ignore_id
    labels_safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
