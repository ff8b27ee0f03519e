"""The LM backbone assembled from an ArchConfig (port of
``repro.nn.transformer``, dense family).

Layers are stacked as in the reference: every leaf of ``params["layers"]``
and of the cache carries a leading (L, ...) axis, and layer i runs on the
views ``[i]``. The MoE, SSM/hybrid, encoder-decoder and VLM families are
not ported yet and raise ``NotImplementedError``.

Modes:
  train   — the full-sequence forward (logits of every position).
  prefill — forward + cache build, returns logits of the last position.
  decode  — one token against the cache.
"""
from __future__ import annotations

import torch

from .attention import attn_apply, attn_init, init_kv_cache
from .layers import (embed, embedding_init, gelu, layernorm, layernorm_init,
                     linear, linear_init, rmsnorm, rmsnorm_init, swiglu,
                     unembed)
from .module import KeyStream
from ..device import resolve_device

# what each family or feature still waits for, by reference module
_NOT_PORTED = {"moe": "repro.nn.moe", "ssm": "repro.nn.ssm",
               "hybrid": "repro.nn.ssm", "encdec": "repro.nn.transformer "
               "(encoder, cross-attention)", "vlm": "repro.nn.layers "
               "(apply_mrope)"}


def require_dense(cfg) -> None:
    """Raise ``NotImplementedError`` naming the reference module a config
    needs that the port does not have yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} needs "
            f"{_NOT_PORTED.get(cfg.family, 'an unported module')}, which is "
            "not ported yet")
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding windows need the ring cache of "
                                  "repro.nn.attention, not ported yet")


def as_dtype(name) -> torch.dtype:
    """A torch dtype from itself or its name (``"bfloat16"``)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# norms / mlp
# ---------------------------------------------------------------------------


def _norm_init(cfg, device, d=None):
    d = d or cfg.d_model
    return (rmsnorm_init(d, device=device) if cfg.norm == "rmsnorm"
            else layernorm_init(d, device=device))


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def mlp_init(gen, cfg, dtype=torch.float32):
    ks = KeyStream(gen)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"gate": linear_init(ks(), d, f, dtype=dtype),
                "up": linear_init(ks(), d, f, dtype=dtype),
                "down": linear_init(ks(), f, d, dtype=dtype)}
    return {"up": linear_init(ks(), d, f, bias=True, dtype=dtype),
            "down": linear_init(ks(), f, d, bias=True, dtype=dtype)}


def mlp_apply(p, x, cfg, *, compute_dtype):
    if cfg.act == "swiglu":
        h = swiglu(linear(p["gate"], x, compute_dtype=compute_dtype),
                   linear(p["up"], x, compute_dtype=compute_dtype))
    else:
        h = gelu(linear(p["up"], x, compute_dtype=compute_dtype))
    return linear(p["down"], h, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# one decoder layer
# ---------------------------------------------------------------------------


def layer_init(gen, cfg, dtype=torch.float32):
    require_dense(cfg)
    ks = KeyStream(gen)
    p = {"ln1": _norm_init(cfg, gen.device),
         "attn": attn_init(ks(), cfg, dtype),
         "ln2": _norm_init(cfg, gen.device)}
    if cfg.d_ff > 0:
        p["mlp"] = mlp_init(ks(), cfg, dtype)
    return p


def layer_apply(p, x, cfg, *, positions, cache=None, cache_pos=0,
                compute_dtype=torch.bfloat16, flash: bool = True):
    """Returns (x, new_cache, aux); ``cache`` is this layer's dict or
    None."""
    new_cache = dict(cache) if cache is not None else None
    h = _norm(cfg, p["ln1"], x)
    mixer_out, kv = attn_apply(
        p["attn"], h, cfg, positions=positions,
        cache=None if cache is None else cache["kv"], cache_pos=cache_pos,
        compute_dtype=compute_dtype, chunk=cfg.attn_chunk, flash=flash)
    if new_cache is not None:
        new_cache["kv"] = kv
    x = x + mixer_out
    if cfg.d_ff > 0:
        x = x + mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), cfg,
                          compute_dtype=compute_dtype)
    return x, new_cache, {}


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_model(gen: torch.Generator, cfg, *, device=None):
    """Seeded parameters on ``device`` (default: the card), drawn from
    generators on ``gen``'s device. Not the reference's bits: parity goes
    through ``repro_torch.weights.lm_from_reference``."""
    require_dense(cfg)
    device = resolve_device(device)
    dtype = as_dtype(cfg.param_dtype)
    ks = KeyStream(gen)
    p = {"embed": embedding_init(ks(), cfg.padded_vocab, cfg.d_model,
                                 dtype=dtype),
         "final_norm": _norm_init(cfg, gen.device)}
    p["layers"] = _stack([layer_init(ks(), cfg, dtype)
                          for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        p["head"] = linear_init(ks(), cfg.d_model, cfg.padded_vocab,
                                dtype=dtype)
    return _to(p, device)


def _cache_pos(cache_pos):
    """An int (all rows aligned) or a (B,) integer tensor (one position per
    row); a 0-d tensor becomes an int."""
    if cache_pos is None:
        return 0
    if isinstance(cache_pos, torch.Tensor):
        return int(cache_pos) if cache_pos.dim() == 0 else cache_pos
    return int(cache_pos)


def model_apply(params, batch, cfg, *, mode: str = "train", cache=None,
                compute_dtype=None, flash: bool = True):
    """Returns (logits, new_cache, aux). ``batch["tokens"]`` is (B, S);
    ``batch["cache_pos"]`` an int, a 0-d or a (B,) tensor (default 0).
    The cache is written in place and returned. ``flash=False`` runs the
    plain attention everywhere (the reference's jnp schedule)."""
    require_dense(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    compute_dtype = as_dtype(compute_dtype or cfg.compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype=compute_dtype)
    cache_pos = _cache_pos(batch.get("cache_pos"))
    base = cache_pos[:, None] if isinstance(cache_pos, torch.Tensor) \
        else cache_pos
    positions = (base + torch.arange(s, device=tokens.device)).expand(b, s)

    for i in range(cfg.n_layers):
        x, _, _ = layer_apply(
            _index(params["layers"], i), x, cfg, positions=positions,
            cache=None if cache is None else _index(cache, i),
            cache_pos=cache_pos, compute_dtype=compute_dtype, flash=flash)

    x = _norm(cfg, params["final_norm"], x)
    if mode in ("prefill", "decode"):
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = linear(params["head"], x, compute_dtype=torch.float32)
    return logits, cache, {}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, length: int, dtype=torch.bfloat16,
               device=None):
    """The stacked decode cache: ``{"kv": {"k", "v": (L, B, KV, length,
    Dh), "positions": (L, B, length)}}`` on ``device`` (default: the
    card)."""
    require_dense(cfg)
    device = resolve_device(device)
    kv = init_kv_cache(batch, cfg.n_kv_heads, length, cfg.head_dim,
                       dtype=as_dtype(dtype), device=device)
    return {"kv": {k: v.unsqueeze(0).repeat(cfg.n_layers,
                                            *([1] * v.dim()))
                   for k, v in kv.items()}}
