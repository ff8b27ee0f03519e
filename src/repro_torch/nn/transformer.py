"""The LM backbone assembled from an ArchConfig (port of
``repro.nn.transformer``: the dense, MoE, SSM, hybrid, encoder-decoder and
VLM families).

Layer parameters are stacked as in the reference: every leaf of
``params["layers"]`` carries a leading (L, ...) axis, and layer i runs on
the views ``[i]``. The cache follows the reference's layout rule: stacked
(L, B, ...) leaves where ``cfg.scan_layers`` (dense, mamba2), a list of
per-layer dicts where not (Hymba, whose three global layers hold
full-length KV caches and whose windowed layers hold rings). The layers
run in a Python loop either way, with per-layer flags as Python bools.
An MoE layer's FFN is ``nn.moe.moe_apply`` (plus the dense MLP beside it
where ``cfg.dense_parallel``); its aux losses, averaged over the layers,
are ``model_apply``'s third result.

The encoder-decoder family (Whisper) runs ``encode`` over precomputed
frame embeddings (the audio frontend is a stub in the reference too) plus
sinusoidal positions: ``cfg.encoder_layers`` non-causal layers without
RoPE (``params["enc_layers"]``, stacked like the decoder's) and
``enc_norm``. Each decoder layer adds a cross-attention block (``cross``,
``ln_cross``) after self-attention: in train and prefill mode its keys and
values are projected from the encoder's output, and a cache's
``cross_k``/``cross_v`` are written with them in place; in decode mode
they are read from the cache. The VLM family (Qwen2-VL) overwrites the
first ``img_tokens`` embeddings with ``batch["image_embeds"]`` (the vision
tower is a stub in the reference too) and rotates q and k by
``batch["mrope_positions"]`` (3, B, S) where given.

``lm_loss`` is the training loss. In train mode with ``cfg.remat`` and
autograd on, each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the layer body): its activations are
recomputed in the backward pass, and with ``remat_policy="dots"`` on the
stacked path the outputs of the matmuls without batch dimensions are
kept. Remat changes no value.

Modes:
  train   — the full-sequence forward (logits of every position).
  prefill — forward + cache build, returns logits of the last position.
  decode  — one token against the cache.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from .attention import attn_apply, attn_init, init_kv_cache
from .layers import (embed, embedding_init, gelu, layernorm, layernorm_init,
                     linear, linear_init, rmsnorm, rmsnorm_init,
                     softmax_xent, swiglu, unembed)
from .module import KeyStream
from .moe import moe_apply, moe_init
from .ssm import init_ssm_state, ssm_apply, ssm_init
from ..device import resolve_device

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the reference does not
    define (every one it defines is ported)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: the port has "
            f"{', '.join(PORTED_FAMILIES)}")


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
    if cfg.cross_attention:
        p["cross"] = attn_init(ks(), cfg, dtype)
        p["ln_cross"] = _norm_init(cfg, dev)
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


def _cross_kv(p, cfg, cache, enc_out, *, compute_dtype):
    """The cross-attention's keys and values (B, KV, Se, Dh): projected
    from ``enc_out`` (and written into the cache's ``cross_k``/``cross_v``
    in place, rounded to the cache's dtype), else the cache's, else
    None."""
    if enc_out is not None:
        b, se, _ = enc_out.shape
        ck, cv = (linear(p["cross"][w], enc_out, compute_dtype=compute_dtype)
                  .reshape(b, se, cfg.n_kv_heads, cfg.head_dim)
                  .transpose(1, 2) for w in ("wk", "wv"))
        if cache is not None and "cross_k" in cache:
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
        return {"k": ck, "v": cv}
    if cache is not None and "cross_k" in cache:
        return {"k": cache["cross_k"], "v": cache["cross_v"]}
    return None


def layer_apply(p, x, cfg, *, positions, cache=None, cache_pos=0,
                is_global=None, mrope_positions=None, enc_out=None,
                compute_dtype=torch.bfloat16, flash: bool = True):
    """Returns (x, cache, aux); ``cache`` is this layer's dict or None,
    written in place. ``is_global``: the layer's flag (Python bool) where
    the config has a sliding window. ``mrope_positions``: M-RoPE's (3, B,
    S) streams; ``enc_out``: the encoder's output (B, Se, D), which the
    cross-attention block reads in train and prefill mode. ``aux`` holds
    an MoE layer's losses, else it is empty."""
    h = _norm(cfg, p["ln1"], x)
    if cfg.family == "ssm":
        return x + _ssm_mix(p, h, cfg, cache, compute_dtype=compute_dtype), \
            cache, {}
    window = cfg.sliding_window
    mixer_out, _ = attn_apply(
        p["attn"], h, cfg, positions=positions,
        cache=None if cache is None else cache["kv"], cache_pos=cache_pos,
        mrope_positions=mrope_positions, window=window,
        is_global=is_global if window is not None else None,
        compute_dtype=compute_dtype, chunk=cfg.attn_chunk, flash=flash)
    if cfg.family == "hybrid":
        s_out = _ssm_mix(p, h, cfg, cache, compute_dtype=compute_dtype)
        mixer_out = 0.5 * (_norm(cfg, p["attn_out_norm"], mixer_out)
                           + _norm(cfg, p["ssm_out_norm"], s_out))
    x = x + mixer_out
    if cfg.cross_attention:
        cross_kv = _cross_kv(p, cfg, cache, enc_out,
                             compute_dtype=compute_dtype)
        if cross_kv is not None:
            cross_out, _ = attn_apply(
                p["cross"], _norm(cfg, p["ln_cross"], x), cfg,
                positions=positions, cross_kv=cross_kv,
                compute_dtype=compute_dtype, chunk=cfg.attn_chunk,
                flash=flash)
            x = x + cross_out
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
    if cfg.family == "encdec":
        enc_cfg = cfg.encoder_cfg()
        p["enc_layers"] = _stacked(lambda i: layer_init(ks(), enc_cfg, dtype),
                                   cfg.encoder_layers, device)
        p["enc_norm"] = _to(_norm_init(cfg, gen.device), device)
    return p


def _sinusoidal(positions, d: int):
    """(B, S) -> (B, S, D) f32 sinusoidal embeddings (Whisper's), sines
    then cosines, frequencies computed in f32 as in the reference."""
    half = d // 2
    dev = positions.device
    neg_log = -torch.full((), 10000.0, dtype=torch.float32, device=dev).log()
    freqs = torch.exp(neg_log * torch.arange(half, dtype=torch.float32,
                                             device=dev) / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frames, cfg, *, compute_dtype=torch.bfloat16,
           flash: bool = True):
    """Whisper's encoder over precomputed frame embeddings (B, Se, D)
    (the frontend is stubbed): sinusoidal positions added, then the
    ``cfg.encoder_cfg()`` layers (non-causal self-attention, no RoPE) and
    ``enc_norm``. Its attention is the flash kernel's non-causal branch
    where ``flash``."""
    enc_cfg = cfg.encoder_cfg()
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device).expand(b, s)
    x = frames.to(compute_dtype) + _sinusoidal(
        positions, cfg.d_model).to(compute_dtype)
    for i in range(cfg.encoder_layers):
        x, _, _ = layer_apply(_index(params["enc_layers"], i), x, enc_cfg,
                              positions=positions,
                              compute_dtype=compute_dtype, flash=flash)
    return _norm(cfg, params["enc_norm"], x)


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


def _remat(cfg):
    """``layer_apply`` under a non-reentrant checkpoint: nothing saved
    (the reference's ``nothing_saveable``), or, for ``remat_policy=
    "dots"`` on the stacked path, the outputs of the products without
    batch dimensions (``checkpoint_dots_with_no_batch_dims``: ``aten.mm``;
    the attention's batched einsums are recomputed)."""
    kw = {}
    if cfg.remat_policy == "dots" and cfg.scan_layers:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default])

    def run(*args, **kwargs):
        return ckpt.checkpoint(layer_apply, *args, use_reentrant=False,
                               **kw, **kwargs)
    return run


def model_apply(params, batch, cfg, *, mode: str = "train", cache=None,
                compute_dtype=None, flash: bool = True):
    """Returns (logits, new_cache, aux). ``batch["tokens"]`` is (B, S);
    ``batch["cache_pos"]`` an int, a 0-d or a (B,) tensor (default 0).
    An encoder-decoder config takes ``batch["frames"]`` (B, Se, D) in
    train and prefill mode (decode reads the cross keys and values from
    the cache); a VLM config takes ``batch["image_embeds"]`` (B, n, D),
    which replace the first n embeddings, and ``batch["mrope_positions"]``
    (3, B, S), both optional. The cache is written in place and returned.
    ``aux`` is each of the layers' aux losses averaged over the layers (an
    MoE model's ``load_balance`` and ``router_z``; empty for the other
    families). ``flash=False`` runs the plain attention everywhere (the
    reference's jnp schedule)."""
    require_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    compute_dtype = as_dtype(compute_dtype or cfg.compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens, compute_dtype=compute_dtype)
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(compute_dtype)
        if img.shape[1] > s:
            raise ValueError(f"{img.shape[1]} image embeddings do not fit "
                             f"a sequence of {s} tokens")
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    mrope_positions = batch.get("mrope_positions")
    cache_pos = _cache_pos(batch.get("cache_pos"))
    base = cache_pos[:, None] if isinstance(cache_pos, torch.Tensor) \
        else cache_pos
    positions = (base + torch.arange(s, device=tokens.device)).expand(b, s)
    enc_out = None
    if cfg.family == "encdec":
        if mode != "decode":
            enc_out = encode(params, batch["frames"], cfg,
                             compute_dtype=compute_dtype, flash=flash)
        x = x + _sinusoidal(positions, cfg.d_model).to(compute_dtype)

    flags = layer_flags(cfg)
    run = (_remat(cfg) if mode == "train" and cfg.remat
           and torch.is_grad_enabled() else layer_apply)
    auxes = []
    for i in range(cfg.n_layers):
        x, _, aux = run(
            _index(params["layers"], i), x, cfg, positions=positions,
            cache=None if cache is None else layer_cache(cache, i),
            cache_pos=cache_pos,
            is_global=None if flags is None else flags["is_global"][i],
            mrope_positions=mrope_positions, enc_out=enc_out,
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
    ring). An encoder-decoder layer also holds ``"cross_k"`` and
    ``"cross_v"`` (B, KV, n_frames, Dh), in ``dtype``. Stacked into (L,
    ...) leaves where ``cfg.scan_layers``, else a list of per-layer dicts,
    as the reference builds it."""
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
        if cfg.cross_attention:
            shape = (batch, cfg.n_kv_heads, cfg.n_frames, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return c

    if cfg.scan_layers:
        return _stacked(one_layer, cfg.n_layers, device)
    return [one_layer(i) for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(params, batch, cfg, *, flash: bool = False):
    """Returns ``(loss, aux)``: the mean token cross-entropy of the train-
    mode logits against ``batch["labels"]``, plus ``0.01 * load_balance +
    0.001 * router_z`` where the model has aux losses (MoE).

    ``flash=False`` (the reference's training formulation) runs the plain
    chunked softmax in every layer. The flash kernel has no backward, and
    ``ops.flash_attention`` raises when autograd would need one, so
    ``flash=True`` is for a loss computed without gradients."""
    logits, _, aux = model_apply(params, batch, cfg, mode="train",
                                 flash=flash)
    loss = softmax_xent(logits, batch["labels"])
    if aux:
        loss = loss + 0.01 * aux.get("load_balance", 0.0) \
                    + 0.001 * aux.get("router_z", 0.0)
    return loss, aux
