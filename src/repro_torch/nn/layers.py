"""Common layers: linear, embedding, norms, rotary embeddings (RoPE and
Qwen2-VL's M-RoPE) and the token cross-entropy (port of
``repro.nn.layers``).

Pure functions over nested-dict params; the compute dtype is the caller's
and params keep the dtype they were made in. The large products are
``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from .module import KeyStream, lecun_normal, trunc_normal
from ..sharding.hints import grad_like

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


def _rows_foldable(x):
    """x with no sharded dim between its first and its last: a DTensor's
    (B, S, D) @ W folds (B, S) into the product's rows, which DTensor
    allows only where S is not split (Megatron-SP's all-gather of the
    sequence before a column-parallel product). A plain tensor as it is."""
    if not isinstance(x, DTensor) or x.dim() <= 2:
        return x
    want = tuple(Replicate() if pl.is_shard() and 0 < pl.dim < x.dim() - 1
                 else pl for pl in x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def matmul(x, w):
    """``x @ w`` for a 2-D ``w``. On a DTensor x of 3 or more dims, the
    rows are folded into one 2-D product exactly where ``at::matmul``
    folds a plain tensor (``w`` requires grad, or x's leading dims are
    one contiguous run), judged on x's local strides: the DTensor's
    global strides can differ (a view's metadata), and with them
    ``at::matmul``'s choice between one ``mm`` and a ``bmm`` of
    expanded weights, which round differently."""
    if not isinstance(x, DTensor) or x.dim() < 3:
        return x @ w
    x = _rows_foldable(x)
    xl = x.to_local()
    st, sh = xl.stride(), xl.shape
    if (w.requires_grad or xl.numel() == 0
            or all(st[i] == st[i + 1] * sh[i + 1]
                   for i in range(x.dim() - 2))):
        y = x.reshape(-1, x.shape[-1]) @ w
        # the view's backward folds the gradient's rows again, so it
        # comes back in the view's layout (``hints.grad_like``)
        return grad_like(y.view(*x.shape[:-1], w.shape[-1]))
    if x.dim() != 3:
        raise NotImplementedError("a strided DTensor product of more than "
                                  "3 dims")
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def linear(p, x, *, compute_dtype=None):
    # under a mesh the input's gradient comes back in its layout: a tensor
    # feeding several products adds their gradients there
    x = grad_like(x)
    w = p["kernel"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = matmul(x, w)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def embedding_init(gen, vocab: int, d_model: int, *, dtype=torch.float32):
    return {"embedding": trunc_normal(gen, (vocab, d_model), std=0.02,
                                      dtype=dtype)}


def embed(p, ids, *, compute_dtype=None):
    """Rows of the table, cast after the gather (the reference casts the
    whole table first; the values are the same). DTensor ids split over
    dp are gathered first, and the caller's hint lays the rows out over dp
    again: torch 2.11's DTensor has no rule for an index by ids split over
    two mesh dims (dp over ``("pod", "data")``), and its rule for the
    gradient of one by ids split over one fails. The table's gradient
    comes back in the table's layout (``hints.grad_like``), as
    ``unembed``'s does: a tied table adds the two there, which torch
    2.11's DTensor cannot do from the index's replicated gradient and the
    head's partial one."""
    if isinstance(ids, DTensor) and any(pl.is_shard()
                                        for pl in ids.placements):
        ids = ids.redistribute(ids.device_mesh,
                               [Replicate()] * ids.device_mesh.ndim)
    rows = grad_like(p["embedding"])[ids]
    return rows if compute_dtype is None else rows.to(compute_dtype)


def unembed(p, x):
    """Tied LM head: logits in f32 for a stable softmax. The table's
    gradient comes back in its layout (see ``embed``)."""
    return matmul(x.to(torch.float32),
                  grad_like(p["embedding"]).to(torch.float32).T)


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


def apply_mrope(x, positions_3d, sections, *, theta: float = 1000000.0):
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency slots are split
    into (temporal, height, width) sections, each driven by its own
    position stream.

    x: (..., S, H, Dh); positions_3d: (3, ..., S); sections sum to Dh//2.
    The whole head rotates, with RoPE's inverse frequencies and
    half-rotation: three equal streams give ``apply_rope``'s values."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {half}")
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    inv = 1.0 / (theta ** exps)
    # each frequency slot's position, from the stream of its section (no
    # index tensor: nothing is copied from the host)
    p3 = positions_3d.to(torch.float32).movedim(0, -1)   # (..., S, 3)
    pos = torch.cat([p3[..., i:i + 1].expand(*p3.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)
    ang = pos * inv                                      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


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
    if isinstance(logits, DTensor):
        # the label's logit out of a vocab-sharded DTensor: every rank
        # keeps it where its shard holds it, and the sum over the vocab
        # (one value and zeros) is exact (DTensor's sharded gather fails)
        ids = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(ids == labels_safe[..., None], logits, 0.0).sum(-1)
    else:
        gold = logits.gather(-1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
