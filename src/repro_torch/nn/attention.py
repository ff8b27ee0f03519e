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

Under a mesh (``sharding.set_mesh``, tensors that are ``DTensor``s) the
reference's ``shard_hint`` calls pin the layouts at its places: heads over
the model axis where they divide it, else the query sequence; a decode
step's KV sequence over the model axis. Two ops have no DTensor rule and
run per rank under ``local_map``: the flash kernel, on each rank's local
heads (or query rows, with the keys cut at the rank's last row, which
keeps the causal mask) with the KV heads those heads read, and the cache
write, each rank writing its batch rows' slots of its sequence shard
(aligned, or each row at its own position).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from .layers import (apply_mrope, apply_rope, linear, linear_init, rmsnorm,
                     rmsnorm_init)
from .module import KeyStream
from ..kernels import ops
from ..sharding.compat import get_abstract_mesh
from ..sharding.hints import hint_spec, rowwise, shard_hint
from ..sharding.rules import placements

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


def _uneven_heads(n: int) -> bool:
    """Under a mesh, whether ``n`` heads do not divide its model axis."""
    am = get_abstract_mesh()
    return not am.empty and n % am.shape.get("model", 1) != 0


def split_heads(y, n: int, dh: int):
    """(B, S, n * Dh) -> (B, S, n, Dh). Under a mesh, the product's
    columns are first pinned over the model axis where the n heads divide
    it; where they do not, the split runs on each rank's batch rows with
    the rest replicated (``rowwise``), in both passes: a DTensor view can
    neither split a sharded dim unevenly nor fold it back (XLA reshards
    there by itself)."""
    b, s, _ = y.shape
    if not isinstance(y, DTensor):
        return y.reshape(b, s, n, dh)
    if _uneven_heads(n):
        return rowwise(lambda t: t.reshape(t.shape[0], s, n, dh), y)
    return shard_hint(y, "dp", None, "model").reshape(b, s, n, dh)


def merge_heads(o):
    """(B, H, S, Dh) -> (B, S, H * Dh), ``wo``'s input. Where the H heads
    do not divide a mesh's model axis, on each rank's batch rows with the
    rest replicated, in both passes (``split_heads``): the gradient that
    ``wo``'s product hands back is sharded over that axis."""
    b, h, s, _ = o.shape
    if isinstance(o, DTensor) and _uneven_heads(h):
        return rowwise(lambda t: t.transpose(1, 2).reshape(t.shape[0], s, -1),
                       o)
    return o.transpose(1, 2).reshape(b, s, -1)


def _project_q(p, x, cfg, *, compute_dtype):
    q = split_heads(linear(p["wq"], x, compute_dtype=compute_dtype),
                    cfg.n_heads, cfg.head_dim)
    return rmsnorm(p["q_norm"], q) if cfg.qk_norm else q


def _project_qkv(p, x, cfg, *, compute_dtype):
    dh = cfg.head_dim
    q = _project_q(p, x, cfg, compute_dtype=compute_dtype)
    k = split_heads(linear(p["wk"], x, compute_dtype=compute_dtype),
                    cfg.n_kv_heads, dh)
    v = split_heads(linear(p["wv"], x, compute_dtype=compute_dtype),
                    cfg.n_kv_heads, dh)
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
    am = get_abstract_mesh()
    seq_ok = (not am.empty and "model" in am.axis_names
              and k.shape[2] % am.shape["model"] == 0)
    if seq_ok:
        k = shard_hint(k, "dp", None, "model", None)
        v = shard_hint(v, "dp", None, "model", None)
    qg = q.reshape(b, kvh, hq // kvh, dh)
    s = torch.einsum("bkgd,bksd->bkgs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale            # (B, KV, g, S)
    if seq_ok:
        s = shard_hint(s, "dp", None, None, "model")
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
    if isinstance(q, DTensor):
        return _flash_sharded(q, k, v, scale=scale, causal=causal)
    dt = torch.promote_types(q.dtype, k.dtype)
    out = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), scale=scale,
                              causal=causal)
    return out.to(q.dtype)


def _kv_for_heads(k, hq: int, h0: int, hl: int):
    """The KV heads that q heads ``h0 .. h0 + hl`` of ``hq`` read, so that
    the kernel's own map (q head j -> KV head j // (hl / KV)) holds."""
    kvh = k.shape[1]
    g = hq // kvh
    if hl % g == 0:
        return k[:, h0 // g:(h0 + hl) // g]
    if g % hl == 0:
        return k[:, h0 // g:h0 // g + 1]
    return k.repeat_interleave(g, dim=1)[:, h0:h0 + hl]


def _flash_sharded(q, k, v, *, scale, causal):
    """The flash kernel on DTensors: each rank runs it under ``local_map``
    on its shard, with the layout the reference's hints pin
    (``attention.py:349-355``): q's heads over the model axis where they
    divide it, else q's rows; k and v replicated over the model axis; the
    batch over dp throughout."""
    mesh = q.device_mesh
    am = get_abstract_mesh()
    tp = am.shape.get("model", 1)
    hq, sq = q.shape[1], q.shape[2]
    skv = k.shape[2]
    if hq % tp == 0:
        q_dims, mode = ("dp", "model", None, None), "heads"
    elif sq % tp == 0:
        q_dims, mode = ("dp", None, "model", None), "rows"
    else:
        q_dims, mode = ("dp", None, None, None), "whole"
    q_pl = placements(am, hint_spec(q.shape, q_dims, am))
    kv_pl = placements(am, hint_spec(k.shape, ("dp", None, None, None), am))
    rank = (mesh.get_local_rank("model")
            if "model" in (mesh.mesh_dim_names or ()) else 0)

    def local(ql, kl, vl):
        if mode == "heads" and tp > 1:
            hl = ql.shape[1]
            kl = _kv_for_heads(kl, hq, rank * hl, hl)
            vl = _kv_for_heads(vl, hq, rank * hl, hl)
        elif mode == "rows" and tp > 1 and causal:
            # keys up to this rank's last query row: query i of the shard
            # sits at skv - sq + rank * n + i, the kernel's causal rule
            end = skv - sq + (rank + 1) * ql.shape[2]
            kl, vl = kl[:, :, :end], vl[:, :, :end]
        dt = torch.promote_types(ql.dtype, kl.dtype)
        return ops.flash_attention(ql.to(dt), kl.to(dt), vl.to(dt),
                                   scale=scale, causal=causal).to(ql.dtype)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


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
    # the reference's TP layout: heads over the model axis where they
    # divide it, else the query sequence, one chunk (its seq_tp)
    am = get_abstract_mesh()
    tp = am.shape.get("model", 1)
    if g > 1:
        kv_dims = ("dp", "model", None, None) if hq % tp == 0 \
            else ("dp", None, None, None)
        k = shard_hint(_repeat_heads(k, g), *kv_dims)
        v = shard_hint(_repeat_heads(v, g), *kv_dims)
    seq_tp = hq % tp != 0 and sq % tp == 0
    if seq_tp:
        chunk = sq
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kp = k_positions[:, None, None, :]                      # (B, 1, 1, Skv)
    cq = sq // max(1, sq // chunk)
    outs = []
    for qc, qpos in zip(q.split(cq, dim=2), q_positions.split(cq, dim=1)):
        if seq_tp:
            qc = shard_hint(qc, "dp", None, "model", None)
        s = _per_head("bhcd,bhsd->bhcs", qc.to(torch.float32), kf) * scale
        if seq_tp:
            s = shard_hint(s, "dp", None, "model", None)
        mask = _mask(qpos[:, None, :, None], kp, causal=causal,
                     window=window, is_global=is_global)
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        outs.append(_per_head("bhcs,bhsd->bhcd",
                              p.to(v.dtype).to(torch.float32), vf
                              ).to(q.dtype))
    return torch.cat(outs, dim=2)


def _per_head(eq: str, x, y):
    """``torch.einsum(eq, x, y)`` for one of attention's products over
    (B, H), x (B, H, Sq, .) and y (B, H, Skv, Dh). On DTensors each rank
    multiplies its own blocks under ``local_map``: x in its layout (batch,
    heads or query rows sharded), y on the same batch and heads with its
    keys whole, the result in x's layout. (DTensor's einsum flattens
    (B, H) to one dim and cannot unflatten it where each rank holds one
    row of a sharded batch and of sharded heads: a microbatch of one row
    a rank.)"""
    if not (isinstance(x, DTensor) and isinstance(y, DTensor)):
        return torch.einsum(eq, x, y)
    x_pl = tuple(x.placements)
    y_pl = tuple(pl if pl.is_shard(0) or pl.is_shard(1) else Replicate()
                 for pl in x_pl)
    # where x's query rows are split and y is whole, each rank's gradient
    # of y is its rows' share: partial sums
    y_grad = tuple(Partial() if xp.is_shard(2) else yp
                   for xp, yp in zip(x_pl, y_pl))
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=list(x_pl), in_placements=(x_pl, y_pl),
                     in_grad_placements=(x_pl, y_grad),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, y)


def _repeat_heads(k, g: int):
    """k (B, KV, S, Dh) with each head repeated g times in place
    (``repeat_interleave``; as an expand and a view on a DTensor, which
    has no rule for the former)."""
    if not isinstance(k, DTensor):
        return k.repeat_interleave(g, dim=1)
    b, kvh, s, dh = k.shape
    return k[:, :, None].expand(b, kvh, g, s, dh).reshape(b, kvh * g, s, dh)


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


def _write_slice(cache, start: int, k_new, v_new, pos: int,
                 offset: int = 0):
    """Slots ``start .. start + n`` of the cache, whose k and v hold the
    slots from ``offset`` on (a sequence shard's; ``positions`` holds all
    of them)."""
    n = k_new.shape[2]
    lo = max(start, offset)
    hi = min(start + n, offset + cache["k"].shape[2])
    if lo < hi:
        cache["k"][:, :, lo - offset:hi - offset] = k_new[:, :, lo - start:
                                                          hi - start]
        cache["v"][:, :, lo - offset:hi - offset] = v_new[:, :, lo - start:
                                                          hi - start]
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
    if isinstance(cache["k"], DTensor):
        return _cache_update_sharded(cache, k_new, v_new, pos, ring=ring)
    length = cache["k"].shape[2]
    s_new = k_new.shape[2]
    if ring and s_new > length:
        k_new, v_new = k_new[:, :, -length:], v_new[:, :, -length:]
        pos = pos + (s_new - length)
        s_new = length
    if isinstance(pos, int):
        _write_aligned(cache, k_new, v_new, pos, ring=ring, length=length)
        return cache

    _write_rows(cache, k_new, v_new, pos, ring=ring, length=length)
    return cache


def _write_rows(cache, k_new, v_new, pos, *, ring: bool, length: int,
                offset: int = 0):
    """A per-row write of (B, KV, s_new, Dh), s_new <= length for a ring,
    at each row's position ``pos`` (B,) into ``cache``, whose k and v hold
    the slots from ``offset`` on (a sequence shard's; ``positions`` holds
    all ``length`` of them). A linear cache drops a row's writes past its
    end; k and v keep only the slots of their shard. Computed on the
    device: one slot a row (decode) and a whole ring take no host read."""
    kc, vc, pc = cache["k"], cache["v"], cache["positions"]
    shard = kc.shape[2]
    s_new = k_new.shape[2]
    abs_pos = (pos.to(torch.int64)[:, None]
               + torch.arange(s_new, device=pos.device))     # (B, s_new)
    slot = abs_pos % length if ring else abs_pos
    rows = torch.arange(kc.shape[0], device=pos.device)[:, None]
    k_rows = k_new.transpose(1, 2).to(kc.dtype)              # (B, s, KV, Dh)
    v_rows = v_new.transpose(1, 2).to(vc.dtype)
    if ring and shard == length:
        # every slot lands and, s_new <= length, is distinct within a row
        kc[rows, :, slot] = k_rows
        vc[rows, :, slot] = v_rows
        pc[rows, slot] = abs_pos.to(torch.int32)
        return
    valid = torch.ones_like(abs_pos, dtype=torch.bool) if ring \
        else abs_pos < length
    local = slot - offset
    mine = valid & (local >= 0) & (local < shard)
    if s_new == 1:
        # one slot a row: a write this shard does not take rewrites a slot
        # of the row with its own contents, so none is dropped on the host
        at = local.clamp(0, shard - 1)
        keep = mine[:, :, None, None]
        kc[rows, :, at] = torch.where(keep, k_rows, kc[rows, :, at])
        vc[rows, :, at] = torch.where(keep, v_rows, vc[rows, :, at])
        at = slot.clamp(max=length - 1)
        pc[rows, at] = torch.where(valid, abs_pos.to(torch.int32),
                                   pc[rows, at])
        return
    r, j = rows.expand_as(abs_pos)[mine], local[mine]
    src = mine.nonzero(as_tuple=True)
    kc[r, :, j] = k_rows[src]
    vc[r, :, j] = v_rows[src]
    r, j = rows.expand_as(abs_pos)[valid], slot[valid]
    pc[r, j] = abs_pos[valid].to(torch.int32)


def _write_aligned(cache, k_new, v_new, pos: int, *, ring: bool,
                   length: int, offset: int = 0):
    """An aligned write of s_new <= length (ring) tokens at ``pos`` into
    ``cache``, whose k and v hold slots ``offset`` on."""
    s_new = k_new.shape[2]
    if ring:
        # at most two runs: up to the ring's end, then from slot 0
        start = pos % length
        first = min(s_new, length - start)
        _write_slice(cache, start, k_new[:, :, :first], v_new[:, :, :first],
                     pos, offset)
        if first < s_new:
            _write_slice(cache, 0, k_new[:, :, first:], v_new[:, :, first:],
                         pos + first, offset)
        return
    if pos < 0 or pos + s_new > length:
        raise ValueError(f"{s_new} tokens at position {pos} do not fit a "
                         f"cache of {length}")
    _write_slice(cache, pos, k_new, v_new, pos, offset)


def _cache_update_sharded(cache, k_new, v_new, pos, *, ring: bool):
    """``cache_update`` of a DTensor cache (k, v sequence-sharded over the
    model axis by ``rules.cache_shardings``, the batch over dp; its
    ``positions`` over dp only): under ``local_map`` each rank writes, for
    its own batch rows, the new tokens' slots that fall in its sequence
    shard, and their positions. ``pos`` is an int (aligned rows) or a (B,)
    integer tensor (continuous batching; plain, or a DTensor), as in the
    plain ``cache_update``; a ring wraps first, and a linear cache drops
    writes past its end."""
    mesh = cache["k"].device_mesh
    k_pl = tuple(cache["k"].placements)
    p_pl = tuple(cache["positions"].placements)
    length = cache["k"].shape[2]
    # the new tokens: the cache's batch layout, every token on each rank
    new_pl = tuple(Replicate() if pl.is_shard(2) else pl for pl in k_pl)
    seq_dims = [i for i, pl in enumerate(k_pl) if pl.is_shard(2)]
    batch_dims = [i for i, pl in enumerate(k_pl) if pl.is_shard(0)]
    s_new = k_new.shape[2]
    if ring and s_new > length:
        k_new, v_new = k_new[:, :, -length:], v_new[:, :, -length:]
        pos = pos + (s_new - length)
    aligned = isinstance(pos, int)
    if isinstance(pos, DTensor):
        pos = pos.redistribute(mesh, p_pl)

    def index(dims):
        i = 0
        for d in dims:
            i = i * mesh.size(d) + mesh.get_local_rank(d)
        return i

    def local(kc, vc, pc, kn, vn, rows_pos=None):
        offset = index(seq_dims) * kc.shape[2]
        part = {"k": kc, "v": vc, "positions": pc}
        if aligned:
            _write_aligned(part, kn, vn, pos, ring=ring, length=length,
                           offset=offset)
            return
        if not isinstance(pos, DTensor):      # every row's: take this rank's
            b0 = index(batch_dims) * kc.shape[0]
            rows_pos = rows_pos[b0:b0 + kc.shape[0]]
        _write_rows(part, kn, vn, rows_pos, ring=ring, length=length,
                    offset=offset)

    # plain new tokens count as replicated, as everywhere under a mesh
    k_new, v_new = (z if isinstance(z, DTensor) else DTensor.from_local(
        z, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for z in (k_new, v_new))
    args = [cache["k"], cache["v"], cache["positions"],
            k_new.to(cache["k"].dtype), v_new.to(cache["v"].dtype)]
    in_pl = [k_pl, k_pl, p_pl, new_pl, new_pl]
    if not aligned:
        args.append(pos)
        in_pl.append(tuple(pos.placements) if isinstance(pos, DTensor)
                     else None)
    local_map(local, out_placements=None, in_placements=tuple(in_pl),
              device_mesh=mesh, redistribute_inputs=True)(*args)
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
        return linear(p["wo"], merge_heads(out),
                      compute_dtype=compute_dtype), cache
    q, k, v = _project_qkv(p, x, cfg, compute_dtype=compute_dtype)
    q, k = _rope(q, k, cfg, positions, mrope_positions)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # the TP layout (reference attention.py:339-355): one query token
    # replicated over the model axis (the cache stays sequence-sharded);
    # else heads over it where they divide it, else the sequence
    am = get_abstract_mesh()
    heads_divide = (not am.empty and "model" in am.axis_names
                    and cfg.n_heads % am.shape["model"] == 0)
    if s == 1:
        q = shard_hint(q, "dp", None, None, None)
    elif heads_divide:
        q = shard_hint(q, "dp", "model", None, None)
    else:
        q = shard_hint(q, "dp", None, "model", None)
    k = shard_hint(k, "dp", None, None, None)
    v = shard_hint(v, "dp", None, None, None)
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
            if s <= length and not isinstance(cache["k"], DTensor):
                ks, vs = cache["k"][:, :, :s], cache["v"][:, :, :s]
            else:
                ks, vs = (z.to(cache["k"].dtype) for z in (k, v))
            out = chunked_attention(q, ks, vs, causal=True, flash=flash,
                                    **attend)
        else:
            qpos = (cache_pos if aligned else cache_pos[:, None]) \
                + torch.arange(s, device=x.device)
            out = attend_cache(q, cache, q_positions=qpos, **attend)
    return linear(p["wo"], merge_heads(out), compute_dtype=compute_dtype), \
        cache
