"""The LM backbone assembled from an ArchConfig (port of
``repro.nn.transformer``: the dense, MoE, SSM and hybrid families).

Layer parameters are stacked as in the reference: every leaf of
``params["layers"]`` carries a leading (L, ...) axis, and layer i runs on
the views ``[i]``. The cache follows the reference's layout rule: stacked
(L, B, ...) leaves where ``cfg.scan_layers`` (dense, mamba2), a list of
per-layer dicts where not (Hymba, whose three global layers hold
full-length KV caches and whose windowed layers hold rings). The layers
run in a Python loop either way, with per-layer flags as Python bools.
An MoE layer's FFN is ``nn.moe.moe_apply`` (plus the dense MLP beside it
where ``cfg.dense_parallel``); its aux losses, averaged over the layers,
are ``model_apply``'s third result. The encoder-decoder and VLM families
are not ported yet and raise ``NotImplementedError``.

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
from .moe import moe_apply, moe_init
from .ssm import init_ssm_state, ssm_apply, ssm_init
from ..device import resolve_device

# what each family still waits for, by reference module
_NOT_PORTED = {"encdec": "repro.nn.transformer (encoder, cross-attention)",
               "vlm": "repro.nn.layers (apply_mrope)"}
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` naming the reference module a config
    needs that the port does not have yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} needs "
            f"{_NOT_PORTED.get(cfg.family, 'an unported module')}, which is "
            "not ported yet")


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
    require_ported(cfg)
    ks = KeyStream(gen)
    dev = gen.device
    p = {"ln1": _norm_init(cfg, dev)}
    if cfg.family != "ssm":
        p["attn"] = attn_init(ks(), cfg, dtype)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_init(ks(), cfg, dtype)
    if cfg.family == "hybrid":
        p["attn_out_norm"] = _norm_init(cfg, dev)
        p["ssm_out_norm"] = _norm_init(cfg, dev)
    if cfg.family != "ssm":
        p["ln2"] = _norm_init(cfg, dev)
        if cfg.n_experts > 0:
            p["moe"] = moe_init(ks(), cfg, dtype)
            if cfg.dense_parallel:
                p["mlp"] = mlp_init(ks(), cfg, dtype)
        elif cfg.d_ff > 0:
            p["mlp"] = mlp_init(ks(), cfg, dtype)
    return p


def _ssm_mix(p, h, cfg, cache, *, compute_dtype):
    """The layer's SSM branch; with a cache, reads its state and writes
    the new state and conv window back into the cache's tensors in place
    (a captured graph keeps its storage)."""
    decode = cache is not None and h.shape[1] == 1
    y, st, cv = ssm_apply(
        p["ssm"], h, cfg, state=None if cache is None else cache["ssm"],
        conv_state=None if cache is None else cache["conv"], decode=decode,
        compute_dtype=compute_dtype)
    if cache is not None:
        cache["ssm"].copy_(st)
        cache["conv"].copy_(cv)
    return y


def layer_apply(p, x, cfg, *, positions, cache=None, cache_pos=0,
                is_global=None, compute_dtype=torch.bfloat16,
                flash: bool = True):
    """Returns (x, cache, aux); ``cache`` is this layer's dict or None,
    written in place. ``is_global``: the layer's flag (Python bool) where
    the config has a sliding window. ``aux`` holds an MoE layer's losses,
    else it is empty."""
    h = _norm(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        return x + _ssm_mix(p, h, cfg, cache, compute_dtype=compute_dtype), \
            cache, {}
    window = cfg.sliding_window
    mixer_out, _ = attn_apply(
        p["attn"], h, cfg, positions=positions,
        cache=None if cache is None else cache["kv"], cache_pos=cache_pos,
        window=window, is_global=is_global if window is not None else None,
        compute_dtype=compute_dtype, chunk=cfg.attn_chunk, flash=flash)
    if cfg.family == "hybrid":
        s_out = _ssm_mix(p, h, cfg, cache, compute_dtype=compute_dtype)
        mixer_out = 0.5 * (_norm(cfg, p["attn_out_norm"], mixer_out)
                           + _norm(cfg, p["ssm_out_norm"], s_out))
    x = x + mixer_out
    aux = {}
    if cfg.n_experts > 0:
        h2 = _norm(cfg, p["ln2"], x)
        y, aux = moe_apply(p["moe"], h2, cfg, compute_dtype=compute_dtype)
        if cfg.dense_parallel:
            y = y + mlp_apply(p["mlp"], h2, cfg, compute_dtype=compute_dtype)
        x = x + y
    elif cfg.d_ff > 0:
        x = x + mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), cfg,
                          compute_dtype=compute_dtype)
    return x, cache, aux


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def _stacked(make, n: int, device):
    """``make(i)`` for i < n, in order, as one tree of (n, ...) leaves on
    ``device``: each tree is copied into its slot and dropped before the
    next is made, so the peak is the stack and one tree (stacking a list
    would hold every leaf twice: 93 GB for stablelm-12b's layers)."""
    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        return torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                           device=device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = None
    for i in range(n):
        tree = make(i)
        out = alloc(tree) if out is None else out
        put(out, tree, i)
        del tree
    return out


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
    through ``repro_torch.weights.lm_from_reference``. Each layer is drawn
    and copied into the stacked (L, ...) leaves before the next is drawn,
    so the peak on the card is the parameters and one layer."""
    require_ported(cfg)
    device = resolve_device(device)
    dtype = as_dtype(cfg.param_dtype)
    ks = KeyStream(gen)
    p = {"embed": _to(embedding_init(ks(), cfg.padded_vocab, cfg.d_model,
                                     dtype=dtype), device),
         "final_norm": _to(_norm_init(cfg, gen.device), device)}
    p["layers"] = _stacked(lambda i: layer_init(ks(), cfg, dtype),
                           cfg.n_layers, device)
    if not cfg.tie_embeddings:
        p["head"] = _to(linear_init(ks(), cfg.d_model, cfg.padded_vocab,
                                    dtype=dtype), device)
    return p


def layer_flags(cfg):
    """Per-layer flags, Python bools: ``{"is_global": [...]}`` (Hymba's
    full-attention layers) where the config has a sliding window, else
    None."""
    if cfg.sliding_window is None:
        return None
    return {"is_global": [i in cfg.global_layers
                          for i in range(cfg.n_layers)]}


def layer_cache(cache, i: int):
    """Layer i's cache: an entry of the per-layer list, or views ``[i]`` of
    the stacked leaves (writes land in the stack)."""
    return cache[i] if isinstance(cache, list) else _index(cache, i)


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
    The cache is written in place and returned. ``aux`` is each of the
    layers' aux losses averaged over the layers (an MoE model's
    ``load_balance`` and ``router_z``; empty for the other families).
    ``flash=False`` runs the plain attention everywhere (the reference's
    jnp schedule)."""
    require_ported(cfg)
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

    flags = layer_flags(cfg)
    auxes = []
    for i in range(cfg.n_layers):
        x, _, aux = layer_apply(
            _index(params["layers"], i), x, cfg, positions=positions,
            cache=None if cache is None else layer_cache(cache, i),
            cache_pos=cache_pos,
            is_global=None if flags is None else flags["is_global"][i],
            compute_dtype=compute_dtype, flash=flash)
        auxes.append(aux)

    x = _norm(cfg, params["final_norm"], x)
    if mode in ("prefill", "decode"):
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = linear(params["head"], x, compute_dtype=torch.float32)
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    return logits, cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, length: int, dtype=torch.bfloat16,
               device=None):
    """The decode cache on ``device`` (default: the card). Each layer holds
    ``{"kv": {"k", "v": (B, KV, L_i, Dh), "positions": (B, L_i)}}`` unless
    the family is ``ssm``, and ``"ssm"`` (B, H, P, N) and ``"conv"`` (B,
    k-1, conv_dim), both f32, for the SSM families. L_i is ``length``, or
    ``min(window, length)`` for a windowed layer that is not global (a
    ring). Stacked into (L, ...) leaves where ``cfg.scan_layers``, else a
    list of per-layer dicts, as the reference builds it."""
    require_ported(cfg)
    device = resolve_device(device)
    dtype = as_dtype(dtype)

    def one_layer(i):
        c = {}
        if cfg.family != "ssm":
            win = cfg.sliding_window
            glob = i in cfg.global_layers if win is not None else True
            clen = length if (win is None or glob) else min(win, length)
            c["kv"] = init_kv_cache(batch, cfg.n_kv_heads, clen,
                                    cfg.head_dim, dtype=dtype, device=device)
        if cfg.family in ("ssm", "hybrid"):
            c["ssm"], c["conv"] = init_ssm_state(batch, cfg, device=device)
        return c

    if cfg.scan_layers:
        return _stacked(one_layer, cfg.n_layers, device)
    return [one_layer(i) for i in range(cfg.n_layers)]
