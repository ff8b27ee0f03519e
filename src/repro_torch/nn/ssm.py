"""Mamba2 (SSD, state-space duality) block: the chunked train/prefill form
and the O(1)-state recurrent decode (port of ``repro.nn.ssm``). Used by
mamba2-130m and the SSM branch of Hymba.

Prefill follows the SSD block decomposition (Dao & Gu 2024, Listing 1):
the sequence is split into chunks; within a chunk the computation is an
attention-like quadratic form, and states pass between chunks through an
exponential-decay recurrence, a loop over chunks here (the reference's
``lax.scan``). Decode keeps a constant-size state (B, H, P, N) and a
(k-1)-deep conv window.

The reference computes every product here in XLA, outside any Pallas
kernel, so the port's are ``torch.einsum`` / ``matmul`` too, with the
reference's casts: the projections in the compute dtype, the conv and the
scan in f32, the gated rmsnorm's input back in the compute dtype.

One difference: a prompt shorter than ``ssm_conv - 1`` tokens leaves a
conv window left-padded with zeros (the causal conv's own padding), where
the reference's slice yields too few rows and its decode then fails.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from .layers import matmul, rmsnorm, rmsnorm_init
from .module import KeyStream, lecun_normal
from ..sharding.hints import grad_like, shard_hint


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, heads, conv_dim


def ssm_init(gen, cfg, dtype=torch.float32):
    ks = KeyStream(gen)
    dev = gen.device
    d = cfg.d_model
    d_inner, heads, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    return {
        # order: [z (d_inner), x (d_inner), B (g*n), C (g*n), dt (heads)]
        "in_proj": lecun_normal(ks(), (d, 2 * d_inner + 2 * g * n + heads),
                                fan_in=d, dtype=dtype),
        "conv_w": lecun_normal(ks(), (cfg.ssm_conv, conv_dim),
                               fan_in=cfg.ssm_conv, dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, heads + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((heads,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": lecun_normal(ks(), (d_inner, d), fan_in=d_inner,
                                 dtype=dtype),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, heads, _ = ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    return zxbcdt.split([d_inner, d_inner + 2 * gn, heads], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, window k: explicit shift-mac (k is tiny).
    On a DTensor, per rank on its batch rows under ``local_map`` (each
    row's conv is its own; the sequence and channels whole): torch 2.11's
    DTensor fails to plan the shifts' pad."""
    if isinstance(xbc, DTensor):
        x_pl = tuple(xbc.placements)
        whole = (Replicate(),) * len(x_pl)
        # a rank's gradient of the weights is its rows' share
        grad = tuple(Partial() if pl.is_shard() else Replicate()
                     for pl in x_pl)
        return local_map(_causal_conv, out_placements=list(x_pl),
                         in_placements=(x_pl, whole, whole),
                         in_grad_placements=(x_pl, grad, grad),
                         device_mesh=xbc.device_mesh,
                         redistribute_inputs=True)(xbc, w, b)
    k = w.shape[0]
    y = xbc * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i, :]
        y = y + shifted * w[k - 1 - i]
    return F.silu(y + b)


def _cumsum(x, dim: int):
    """``torch.cumsum``; on a DTensor per rank under ``local_map``, ``dim``
    whole (torch 2.11's DTensor has no rule for the flip in its
    backward)."""
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    dim %= x.dim()
    pl = tuple(Replicate() if q.is_shard(dim) else q for q in x.placements)
    return local_map(lambda t: torch.cumsum(t, dim), out_placements=list(pl),
                     in_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def _pad_seq(x, pad: int):
    """``x`` with ``pad`` rows of zeros after its dim 1 (the sequence); on
    a DTensor per rank under ``local_map``, dim 1 whole (torch 2.11's
    DTensor fails to plan the pad)."""
    def pad_rows(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    if not isinstance(x, DTensor):
        return pad_rows(x)
    pl = tuple(Replicate() if q.is_shard(1) else q for q in x.placements)
    return local_map(pad_rows, out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    L[i, j] = sum a[j+1..i], -inf above the diagonal."""
    q = a.shape[-1]
    cs = _cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int, init_state=None):
    """SSD forward. x: (B, S, H, P); dt: (B, S, H); a: (H,) (negative);
    b_mat/c_mat: (B, S, G, N). Returns (y (B, S, H, P), final_state
    (B, H, P, N))."""
    bsz, s, h, p_dim = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g

    # chunk views; SSM groups broadcast to heads up front (g | h)
    xc = x.reshape(bsz, nc, chunk, h, p_dim)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bh = b_mat.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    ch = c_mat.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    da = dtc * a                                           # (B,nc,Q,H)
    da_cum = _cumsum(da, 2)                                # within a chunk
    da_total = da_cum[:, :, -1]                            # (B,nc,H)

    # intra-chunk (diagonal blocks): an attention-like quadratic form
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))      # (B,nc,H,Q,Q)
    cb = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)        # (B,nc,H,Q,Q)
    # the reference's multi-operand einsums as pairwise contractions, the
    # per-step scalars multiplied in first (torch's own order for them
    # formed (..., P, N) outer products elementwise: on an H100 most of a
    # mamba2-130m prefill's device time)
    scores = cb * lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # the state each chunk emits
    decay_states = torch.exp(da_total[:, :, None, :] - da_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          bh * (decay_states * dtc)[..., None], xc)

    # inter-chunk recurrence: the state before each chunk
    prev = (torch.zeros((bsz, h, p_dim, n), dtype=torch.float32,
                        device=x.device) if init_state is None
            else init_state.to(torch.float32))
    before = []
    for c in range(nc):
        before.append(prev)
        prev = states[:, c] + prev * torch.exp(da_total[:, c])[:, :, None,
                                                               None]
    prev_states = torch.stack(before, dim=1)               # (B,nc,H,P,N)

    # what the carried-in states contribute
    state_decay = torch.exp(da_cum)                        # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", ch, prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p_dim)
    return y, prev


def ssm_apply(p, x, cfg, *, state=None, conv_state=None, decode: bool = False,
              chunk: int = 128, compute_dtype=torch.bfloat16):
    """x: (B, S, D). Returns (y (B, S, D), new_state (B, H, P, N) f32,
    new_conv_state (B, k-1, conv_dim) f32); new tensors, the caller stores
    them. ``decode`` (S == 1) takes the recurrent step from ``state`` and
    ``conv_state``; otherwise the chunked scan from ``state`` (zeros if
    None), the conv padded with zeros."""
    bsz, s, _ = x.shape
    d_inner, heads, _ = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    p_dim = cfg.ssm_head_dim
    k_conv = cfg.ssm_conv

    zxbcdt = matmul(x.to(compute_dtype), p["in_proj"].to(compute_dtype))
    if cfg.family == "hybrid":
        # under a mesh, batch over dp (the reference's hybrid-only pin)
        zxbcdt = shard_hint(zxbcdt, "dp", None, "model")
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])   # (B,S,H)
    a = -torch.exp(p["a_log"])                             # (H,)
    xbc = xbc.to(torch.float32)
    w = p["conv_w"].to(torch.float32)
    b = p["conv_b"].to(torch.float32)

    if decode:
        # the conv window: the last k-1 inputs, then this one
        window = torch.cat([conv_state, xbc], dim=1)        # (B,k,conv)
        xin = F.silu(torch.einsum("bkc,kc->bc", window, w) + b)[:, None]
        new_conv_state = window[:, 1:]
    else:
        # under a mesh, batch over dp and the rest whole (the conv runs
        # per rank on its rows)
        xbc = shard_hint(xbc, "dp", None, None)
        xin = _causal_conv(xbc, w, b)
        new_conv_state = xbc[:, -(k_conv - 1):]
        short = k_conv - 1 - new_conv_state.shape[1]
        if short > 0:
            new_conv_state = F.pad(new_conv_state, (0, 0, short, 0))

    xs, bmat, cmat = xin.split([d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, -1, heads, p_dim)
    bmat = bmat.reshape(bsz, -1, g, n)
    cmat = cmat.reshape(bsz, -1, g, n)

    if decode:
        # the recurrent step: state' = exp(dt a) state + dt B x
        dt1 = dt[:, 0]                                      # (B,H)
        da = torch.exp(dt1 * a)
        bx = torch.einsum("bgn,bhp->bhpn", bmat[:, 0],
                          xs[:, 0] * dt1[..., None])
        new_state = state * da[:, :, None, None] + bx
        y = torch.einsum("bgn,bhpn->bhp", cmat[:, 0], new_state)[:, None]
    else:
        pad = (-s) % chunk
        if pad:
            xs_p, dt_p, bmat, cmat = (_pad_seq(t, pad)
                                      for t in (xs, dt, bmat, cmat))
        else:
            xs_p, dt_p = xs, dt
        y, new_state = ssd_chunked(xs_p, dt_p, a, bmat, cmat, chunk=chunk,
                                   init_state=state)
        y = y[:, :s]

    y = y + xs[:, :s] * p["d_skip"][:, None]               # D skip
    y = grad_like(y.reshape(bsz, s, d_inner))
    y = rmsnorm(p["norm"],
                (y * F.silu(z.to(torch.float32))).to(compute_dtype))
    out = matmul(y, p["out_proj"].to(compute_dtype))
    return out.to(x.dtype), new_state, new_conv_state


def init_ssm_state(batch: int, cfg, dtype=torch.float32, device=None):
    """Zero SSM state (B, H, P, N) and conv window (B, k-1, conv_dim)."""
    _, heads, conv_dim = ssm_dims(cfg)
    return (torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=dtype, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                        device=device))
