"""Mixture-of-Experts with sort-based dispatch (port of ``repro.nn.moe``).

Tokens are routed top-k over the router's softmax, then sorted by expert id
within each batch row (a stable sort, so each expert's tokens keep their
order). An (E, C) slot table of token indices comes from searchsorted
offsets into the sorted ids; C is ``capacity(S, k, E, factor)``. The
expert SwiGLU runs as three batched products over all E x C slots, and the
slot outputs, scaled by their gates, are added back into their tokens.
Tokens past an expert's capacity are dropped from it and fall through on
the residual, in the reference's order.

Routing is discrete: a token whose 8th and 9th experts swap, or whose slot
moves past capacity, changes by far more than any tolerance. So the router
product runs in f32 without TF32 on the card, and the combine adds each
token's slot outputs in the reference's order (ascending expert id), in the
compute dtype, rounded after each add: the reference's scatter-add into a
bf16 zeros tensor does exactly that, which an f32 sum rounded once or an
``index_add_`` (atomics on the card) would not.

Every op runs on the device with no host read, so a step that routes is
captured whole in a CUDA graph. The reference's ``shard_hint`` calls are
the identity without a mesh and are left out.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .layers import swiglu
from .module import KeyStream, lecun_normal


def moe_init(gen, cfg, dtype=torch.float32):
    """The router (d, E), always f32, and the stacked experts' SwiGLU
    weights (E, d, f), (E, d, f), (E, f, d) in ``dtype``."""
    ks = KeyStream(gen)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": lecun_normal(ks(), (d, e), fan_in=d, dtype=torch.float32),
        "w_gate": lecun_normal(ks(), (e, d, f), fan_in=d, dtype=dtype),
        "w_up": lecun_normal(ks(), (e, d, f), fan_in=d, dtype=dtype),
        "w_down": lecun_normal(ks(), (e, f, d), fan_in=f, dtype=dtype),
    }


def capacity(tokens_per_group: int, top_k: int, n_experts: int,
             factor: float = 1.25) -> int:
    c = int(tokens_per_group * top_k * factor / n_experts) + 1
    return max(1, min(c, tokens_per_group * top_k))


@contextlib.contextmanager
def _full_f32(device):
    """cuBLAS in full f32 on the card for the block (TF32 keeps ~3 decimal
    digits, enough to swap two experts' ranks); the caller's setting is
    put back after."""
    if device.type != "cuda":
        yield
        return
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class Routing(NamedTuple):
    logits: torch.Tensor    # (B, S, E) f32, the router's
    probs: torch.Tensor     # (B, S, E) its softmax
    idx: torch.Tensor       # (B, S, K) the top-k experts, by probability
    tok: torch.Tensor       # (B, E, C) the token in each slot
    gate: torch.Tensor      # (B, E, C) its gate, 0 where the slot is empty
    valid: torch.Tensor     # (B, E, C) whether the slot holds a token

    def dropped(self) -> torch.Tensor:
        """(token, expert) choices past capacity, a 0-d tensor."""
        return self.idx.numel() - self.valid.sum()


def route(p, x, cfg) -> Routing:
    """The reference's routing of x (B, S, D): top-k over the softmax of
    the f32 router logits (renormalised where ``moe_norm_topk``), a stable
    sort by expert id within each row, and the (E, C) slot table."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(s, k, e, cfg.moe_capacity_factor)
    dev = x.device
    with _full_f32(dev):
        logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg.moe_norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # sort the (token, choice) pairs of each row by expert id
    flat_e = idx.reshape(b, s * k)
    # each choice's token (an int repeat_interleave reads its size back)
    flat_t = (torch.arange(s * k, device=dev) // k).expand(b, -1)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    st = flat_t.gather(1, order)
    sg = gates.reshape(b, s * k).gather(1, order)

    # slot table (E, C): expert j's tokens sit at se[starts[j]:ends[j]]
    eids = torch.arange(e, device=dev).expand(b, e).contiguous()
    starts = torch.searchsorted(se, eids, side="left")
    ends = torch.searchsorted(se, eids, side="right")
    slots = starts[:, :, None] + torch.arange(c, device=dev)
    valid = slots < ends[:, :, None]
    slots_c = slots.clamp(0, s * k - 1).reshape(b, e * c)
    tok = st.gather(1, slots_c).reshape(b, e, c)
    gate = torch.where(valid, sg.gather(1, slots_c).reshape(b, e, c), 0.0)
    return Routing(logits, probs, idx, tok, gate, valid)


def experts_apply(p, xin, *, compute_dtype):
    """The experts' SwiGLU over their slots: xin (B, E, C, D) -> (B, E, C,
    D), one batched product (batch E) a weight, over all B x C rows of an
    expert."""
    b, e, c, d = xin.shape
    xe = xin.transpose(0, 1).reshape(e, b * c, d)
    h = swiglu(torch.bmm(xe, p["w_gate"].to(compute_dtype)),
               torch.bmm(xe, p["w_up"].to(compute_dtype)))
    out = torch.bmm(h, p["w_down"].to(compute_dtype))
    return out.reshape(e, b, c, d).transpose(0, 1)


def combine(out, tok, valid, s: int, top_k: int):
    """out (B, E*C, D), the slot table's outputs in slot order, added into
    a (B, S, D) zeros tensor of out's dtype as the reference's scatter-add
    does: each token's slots one at a time in slot order (ascending expert
    id), rounded to the dtype after each add. A token holds at most
    ``top_k`` slots (one an expert it chose); empty slots add nothing."""
    b, n, d = out.shape
    dev = out.device
    # slots grouped by token, each token's in slot order; empty ones last
    slot_ids = torch.arange(n, device=dev)
    key = torch.where(valid.reshape(b, n), tok.reshape(b, n) * n + slot_ids,
                      s * n)
    sorted_key, perm = torch.sort(key, dim=1)
    firsts = torch.arange(s, device=dev).expand(b, s).contiguous() * n
    tstart = torch.searchsorted(sorted_key, firsts, side="left")
    tend = torch.searchsorted(sorted_key, firsts + n, side="left")
    y = torch.zeros((b, s, d), dtype=out.dtype, device=dev)
    for j in range(top_k):
        pos = tstart + j
        slot = perm.gather(1, pos.clamp(max=n - 1))
        rows = out.gather(1, slot[..., None].expand(b, s, d))
        y = y + torch.where((pos < tend)[..., None], rows, 0.0)
    return y


def moe_apply(p, x, cfg, *, compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> (B, S, D) in x's dtype, and the aux losses
    ``{"load_balance", "router_z"}``. Groups are batch rows."""
    b, s, d = x.shape
    e = cfg.n_experts
    r = route(p, x, cfg)
    c = r.tok.shape[-1]

    xin = x.gather(1, r.tok.reshape(b, e * c, 1).expand(b, e * c, d))
    xin = (xin.reshape(b, e, c, d) * r.valid[..., None]).to(compute_dtype)
    out = experts_apply(p, xin, compute_dtype=compute_dtype)
    out = out * r.gate[..., None].to(compute_dtype)
    y = combine(out.reshape(b, e * c, d), r.tok, r.valid, s, cfg.top_k)

    # aux: Switch-style load balance over the top-1 choice; router z-loss
    me = r.probs.mean(dim=(0, 1))
    top1 = r.idx[..., :1] == torch.arange(e, device=x.device)
    ce = top1.to(torch.float32).mean(dim=(0, 1))
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(r.logits, -1) ** 2)}
    return y.to(x.dtype), aux
