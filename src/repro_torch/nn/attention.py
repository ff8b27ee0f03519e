"""Attention for the LM stack (port of ``repro.nn.attention``: GQA, RoPE /
partial RoPE / M-RoPE, QK-norm, QKV bias, sliding windows with Hymba's
per-layer global flag, linear and ring-buffer KV caches, and Whisper's
cross-attention).

Full-sequence causal attention whose positions are the default contiguous
ones, and whose window (if any) cannot mask a key, runs
``kernels.ops.flash_attention``, the kernel that the reference names as
the TPU form of ``chunked_attention``'s schedule: train and prefill
without a cache, and a prompt into a cache at ``cache_pos == 0``, which
attends over its own keys. On the card that is
``csrc/flash_attention_tc.cu`` for bf16 (every head dim a multiple of 8 up
to 192: the configs' 64, 128 and stablelm-12b's 160) and
``csrc/flash_attention.cu`` for f32 (32, 64, 128, 160); a head dim the
kernel does not take raises there (``kernels/flash_attention.py:
HEAD_DIMS``), with no fallback. Every other case (decode, prefill at an
offset, per-row positions) is the reference's plain chunked softmax, in
torch. So is a prompt longer than its layer's window: the reference has no
Pallas kernel for windowed attention, so that branch is the reference's
own schedule, not a kernel's plain stand-in.

M-RoPE (Qwen2-VL, ``mrope_positions`` (3, B, S)) rotates q and k by three
position streams; the causal mask stays by sequence index, as in the
reference (whose ``chunked_attention`` gets ``positions[0]``, not the
streams), so an M-RoPE prefill takes the flash kernel as any other.
Cross-attention (Whisper's decoder, ``cross_kv``) attends non-causally
over the encoder's precomputed keys and values: through the flash kernel
for more than one query (Nq != Nkv, 1500 keys at full width, the keys past
the last tile masked by the kernel), by the plain grouped softmax for one
(decode).

A prompt longer than a ring cache attends over its own keys, as the
reference's train-mode forward does, and only then leaves its last
``length`` keys in the ring. (The reference's prefill attends over the
ring it has just truncated, so its query rows before the last ``window``
positions lose keys they should see.)

Conventions: x is (B, S, D); caches are (B, KV, S_cache, Dh); all softmax
math in f32. Layer flags (``is_global``) are Python bools. Unlike the
reference, whose arrays are immutable, ``cache_update`` writes the cache in
place and returns it.
"""
from __future__ import annotations

import torch

from .layers import (apply_mrope, apply_rope, linear, linear_init, rmsnorm,
                     rmsnorm_init)
from .module import KeyStream
from ..kernels import ops

NEG_INF = -1e30


def attn_init(gen, cfg, dtype=torch.float32):
    ks = KeyStream(gen)
    dh = cfg.head_dim
    p = {
        "wq": linear_init(ks(), cfg.d_model, cfg.n_heads * dh,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wk": linear_init(ks(), cfg.d_model, cfg.n_kv_heads * dh,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wv": linear_init(ks(), cfg.d_model, cfg.n_kv_heads * dh,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wo": linear_init(ks(), cfg.n_heads * dh, cfg.d_model, bias=False,
                          dtype=dtype),
    }
    if cfg.qk_norm:
        dev = p["wq"]["kernel"].device
        p["q_norm"] = rmsnorm_init(dh, dtype, dev)
        p["k_norm"] = rmsnorm_init(dh, dtype, dev)
    return p


def _project_q(p, x, cfg, *, compute_dtype):
    b, s, _ = x.shape
    q = linear(p["wq"], x, compute_dtype=compute_dtype).reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    return rmsnorm(p["q_norm"], q) if cfg.qk_norm else q


def _project_qkv(p, x, cfg, *, compute_dtype):
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = _project_q(p, x, cfg, compute_dtype=compute_dtype)
    k = linear(p["wk"], x, compute_dtype=compute_dtype).reshape(
        b, s, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x, compute_dtype=compute_dtype).reshape(
        b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _rope(q, k, cfg, positions, mrope_positions=None):
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        theta=cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        theta=cfg.rope_theta)
    elif cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       rotary_frac=cfg.rotary_frac)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       rotary_frac=cfg.rotary_frac)
    return q, k


def _mask(qp, kp, *, causal, window, is_global):
    """Which keys a query sees: filled slots (``kp >= 0``), causally, and
    within ``window`` positions unless the layer is global."""
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window is not None and not is_global:
        mask = mask & ((qp - kp) < window)
    return mask


def _decode_grouped(q, k, v, *, scale, causal, q_positions, k_positions,
                    window=None, is_global=None):
    """One-token attention without expanding KV to the q heads.

    q: (B, Hq, 1, Dh); k, v: (B, KV, S, Dh); positions per row, (B, 1) and
    (B, S). Products of the stored dtype, accumulated in f32 (the
    reference's ``preferred_element_type``)."""
    b, hq, _, dh = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, hq // kvh, dh)
    s = torch.einsum("bkgd,bksd->bkgs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale            # (B, KV, g, S)
    mask = _mask(q_positions[:, None, None, :], k_positions[:, None, None, :],
                 causal=causal, window=window, is_global=is_global)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, hq, 1, dh).to(q.dtype)


def _flash(q, k, v, *, scale, causal):
    """Contiguous-position attention through the flash kernel, operands in
    their common dtype. The kernel maps each q head to its KV head (the
    reference's ``jnp.repeat(k, g, axis=1)``) and reads strided views in
    place, so neither the GQA expansion nor a cache slice is copied."""
    dt = torch.promote_types(q.dtype, k.dtype)
    out = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), scale=scale,
                              causal=causal)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, scale: float, causal: bool = True,
                      q_positions=None, k_positions=None, window=None,
                      is_global=None, chunk: int = 512, flash: bool = True):
    """Attention of q (B, Hq, Sq, Dh) over k, v (B, KV, Skv, Dh), GQA via
    Hq = KV * group.

    q_positions: (Sq,) or per-row (B, Sq) absolute query positions;
    k_positions: (Skv,) or per-row (B, Skv) key positions, negative for an
    empty cache slot. ``window``: a sliding window's width (a query sees
    keys fewer than ``window`` positions back) unless ``is_global``. Left
    as None the positions are the contiguous default, query i at
    ``Skv - Sq + i`` and key j at j; then, for Sq > 1 (and Sq <= Skv when
    causal) and a window no key reaches (Skv <= window, or global),
    ``flash=True`` runs the flash kernel. Otherwise the reference's plain
    schedule: one-token decode without the GQA expansion, or softmax over
    q chunks of ``chunk`` rows (the rows are independent, so the chunking
    bounds memory and changes no value).
    """
    b, hq, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    unmasked = window is None or is_global or skv <= window
    if (flash and sq > 1 and q_positions is None and k_positions is None
            and (not causal or sq <= skv) and unmasked):
        return _flash(q, k, v, scale=scale, causal=causal)

    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev) + (skv - sq)
    if k_positions is None:
        k_positions = torch.arange(skv, device=dev)
    q_positions = torch.atleast_2d(q_positions).expand(b, sq)
    k_positions = torch.atleast_2d(k_positions).expand(b, skv)
    if sq == 1:
        return _decode_grouped(q, k, v, scale=scale, causal=causal,
                               q_positions=q_positions,
                               k_positions=k_positions, window=window,
                               is_global=is_global)
    g = hq // kvh
    if g > 1:
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kp = k_positions[:, None, None, :]                      # (B, 1, 1, Skv)
    cq = sq // max(1, sq // chunk)
    outs = []
    for qc, qpos in zip(q.split(cq, dim=2), q_positions.split(cq, dim=1)):
        s = torch.einsum("bhcd,bhsd->bhcs", qc.to(torch.float32), kf) * scale
        mask = _mask(qpos[:, None, :, None], kp, causal=causal,
                     window=window, is_global=is_global)
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        outs.append(torch.einsum("bhcs,bhsd->bhcd",
                                 p.to(v.dtype).to(torch.float32), vf
                                 ).to(q.dtype))
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, kv_heads: int, length: int, head_dim: int,
                  dtype=torch.bfloat16, device=None):
    """Linear KV cache. ``positions`` is per row (B, length): the absolute
    position stored in each slot (-1 = empty), so one decode step can serve
    a continuous-batching pool whose rows sit at different offsets; it also
    makes linear and ring-buffer caches one layout."""
    return {
        "k": torch.zeros((batch, kv_heads, length, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, kv_heads, length, head_dim), dtype=dtype,
                         device=device),
        "positions": torch.full((batch, length), -1, dtype=torch.int32,
                                device=device),
    }


def _write_slice(cache, start: int, k_new, v_new, pos: int):
    n = k_new.shape[2]
    cache["k"][:, :, start:start + n] = k_new
    cache["v"][:, :, start:start + n] = v_new
    cache["positions"][:, start:start + n] = torch.arange(
        pos, pos + n, dtype=torch.int32, device=k_new.device)


def cache_update(cache, k_new, v_new, pos, *, ring: bool = False):
    """Write (B, KV, S_new, Dh) at absolute position ``pos``, in place, and
    return the cache.

    ``pos`` is an int (all rows aligned: contiguous slices) or a (B,)
    integer tensor (continuous batching: a per-row scatter, computed on
    the device). ``ring=True`` wraps slot indices modulo the cache length
    (a sliding-window cache); a write longer than the ring keeps its last
    ``length`` tokens, at ``pos + (S_new - length)`` onwards, as in the
    reference. A linear cache refuses an aligned write that does not fit;
    as in the reference's scatter, a row's writes past its end are
    dropped."""
    length = cache["k"].shape[2]
    s_new = k_new.shape[2]
    if ring and s_new > length:
        k_new, v_new = k_new[:, :, -length:], v_new[:, :, -length:]
        pos = pos + (s_new - length)
        s_new = length
    if isinstance(pos, int):
        if ring:
            # at most two runs: up to the ring's end, then from slot 0
            start = pos % length
            first = min(s_new, length - start)
            _write_slice(cache, start, k_new[:, :, :first],
                         v_new[:, :, :first], pos)
            if first < s_new:
                _write_slice(cache, 0, k_new[:, :, first:],
                             v_new[:, :, first:], pos + first)
            return cache
        if pos < 0 or pos + s_new > length:
            raise ValueError(f"{s_new} tokens at position {pos} do not fit a "
                             f"cache of {length}")
        _write_slice(cache, pos, k_new, v_new, pos)
        return cache

    b = cache["k"].shape[0]
    abs_pos = (pos.to(torch.int64)[:, None]
               + torch.arange(s_new, device=pos.device))     # (B, s_new)
    rows = torch.arange(b, device=pos.device)[:, None]
    k_rows = k_new.transpose(1, 2)                           # (B, s, KV, Dh)
    v_rows = v_new.transpose(1, 2)
    if ring:
        # every slot is valid and, s_new <= length, distinct within a row
        slot = abs_pos % length
        cache["k"][rows, :, slot] = k_rows.to(cache["k"].dtype)
        cache["v"][rows, :, slot] = v_rows.to(cache["v"].dtype)
        cache["positions"][rows, slot] = abs_pos.to(torch.int32)
        return cache
    if s_new == 1:
        # one slot a row: a write past the end rewrites the last slot with
        # its own contents, so no host sync is needed to drop it
        valid = abs_pos < length
        slot = abs_pos.clamp(max=length - 1)
        keep = valid[:, :, None, None]
        cache["k"][rows, :, slot] = torch.where(
            keep, k_rows.to(cache["k"].dtype), cache["k"][rows, :, slot])
        cache["v"][rows, :, slot] = torch.where(
            keep, v_rows.to(cache["v"].dtype), cache["v"][rows, :, slot])
        cache["positions"][rows, slot] = torch.where(
            valid, abs_pos.to(torch.int32), cache["positions"][rows, slot])
        return cache
    valid = abs_pos < length
    r, j = rows.expand_as(abs_pos)[valid], abs_pos[valid]
    src = valid.nonzero(as_tuple=True)
    cache["k"][r, :, j] = k_rows[src].to(cache["k"].dtype)
    cache["v"][r, :, j] = v_rows[src].to(cache["v"].dtype)
    cache["positions"][r, j] = j.to(torch.int32)
    return cache


def attend_cache(q, cache, *, scale: float, q_positions, window=None,
                 is_global=None, chunk: int = 512):
    """Attention of q (B, Hq, Sq, Dh) against a (possibly ring) cache."""
    return chunked_attention(
        q, cache["k"], cache["v"], scale=scale, causal=True,
        q_positions=q_positions, k_positions=cache["positions"],
        window=window, is_global=is_global, chunk=chunk)


# ---------------------------------------------------------------------------
# the full attention block
# ---------------------------------------------------------------------------


def attn_apply(p, x, cfg, *, positions, cache=None, cache_pos=0,
               mrope_positions=None, window=None, is_global=None,
               cross_kv=None, compute_dtype=torch.bfloat16,
               chunk: int = 512, flash: bool = True):
    """Attention; returns (out, cache). ``positions`` (B, S) are
    ``cache_pos + arange(S)`` per row, as ``model_apply`` builds them;
    ``cache_pos`` is an int or, for continuous-batching decode, a (B,)
    tensor. ``mrope_positions`` (3, B, S): M-RoPE's streams, where the
    config has sections (else RoPE by ``positions``). ``window``/
    ``is_global``: the layer's sliding window and whether it is a global
    layer. Modes:
      - train/prefill: cache=None -> self-attention over x;
      - prefill with a cache at cache_pos=0 -> fills the cache and attends
        over the prompt's own keys;
      - decode: x is (B, 1, D), cache_pos the current position(s);
      - cross: ``cross_kv`` = {"k", "v"} (B, KV, Se, Dh) precomputed ->
        non-causal attention of q over them, no RoPE, no cache (the
        reference also projects k and v from x here and drops them; they
        are not computed).
    The cache is a ring, as in the reference, iff ``window`` is set and
    the cache is no longer than it (a global layer's too, when its cache
    is that short). ``flash=False`` runs the plain chunked softmax
    everywhere.
    """
    b, s, _ = x.shape
    scale = cfg.head_dim ** -0.5
    if cross_kv is not None:
        q = _project_q(p, x, cfg, compute_dtype=compute_dtype).transpose(1, 2)
        out = chunked_attention(q, cross_kv["k"], cross_kv["v"], scale=scale,
                                causal=False, chunk=chunk, flash=flash)
        out = out.transpose(1, 2).reshape(b, s, -1)
        return linear(p["wo"], out, compute_dtype=compute_dtype), cache
    q, k, v = _project_qkv(p, x, cfg, compute_dtype=compute_dtype)
    q, k = _rope(q, k, cfg, positions, mrope_positions)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    aligned = isinstance(cache_pos, int)
    attend = dict(scale=scale, window=window, is_global=is_global,
                  chunk=chunk)

    if cache is None:
        contiguous = aligned and cache_pos == 0
        out = chunked_attention(
            q, k, v, causal=cfg.causal,
            q_positions=None if contiguous else positions[0], flash=flash,
            **attend)
    else:
        length = cache["k"].shape[2]
        ring = window is not None and length <= window
        cache = cache_update(cache, k, v, cache_pos, ring=ring)
        if aligned and cache_pos == 0 and s > 1:
            # a prompt attends over its own keys: stored at slot j =
            # position j (the slots past it are empty or stale and masked
            # by causality), or, past a ring's length, as computed (the
            # reference's train-mode forward), rounded as stored
            if s <= length:
                ks, vs = cache["k"][:, :, :s], cache["v"][:, :, :s]
            else:
                ks, vs = (z.to(cache["k"].dtype) for z in (k, v))
            out = chunked_attention(q, ks, vs, causal=True, flash=flash,
                                    **attend)
        else:
            qpos = (cache_pos if aligned else cache_pos[:, None]) \
                + torch.arange(s, device=x.device)
            out = attend_cache(q, cache, q_positions=qpos, **attend)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return linear(p["wo"], out, compute_dtype=compute_dtype), cache
