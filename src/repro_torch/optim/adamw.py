"""AdamW with global-norm clipping and a warmup + cosine schedule (port of
``repro.optim.adamw``).

Params, gradients and moments are nested dicts of tensors with the same
keys. The update runs in f32 whatever ``state_dtype`` stores the moments
in (bf16 is allowed). The arithmetic is the reference's, which
``torch.optim.AdamW`` does not reproduce: weight decay, only for tensors
of two or more dimensions, is added to the Adam direction before the
learning rate multiplies it, and ``eps`` is added after ``sqrt(vhat)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32


def _map(fn, *trees):
    """``fn`` over the leaves of dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup to ``peak_lr``, then a
    cosine down to ``min_lr_frac * peak_lr`` at ``decay_steps``."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: dict, cfg: OptConfig) -> dict:
    """Zero moments in ``state_dtype`` beside each param, and step 0."""
    def zeros(p):   # in p's layout, for a DTensor
        return torch.zeros_like(p, dtype=cfg.state_dtype)
    device = next(_leaves(params)).device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _leaves(tree)))


def update(grads: dict, state: dict, params: dict, cfg: OptConfig) -> tuple:
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    # a true division (``scalar / tensor`` multiplies by a reciprocal)
    scale = torch.clamp(torch.div(torch.full_like(gnorm, cfg.clip_norm),
                                  torch.clamp(gnorm, min=1e-9)), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = _map(upd, grads, state["m"], state["v"], params)
    new_p, m, v = (_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"m": m, "v": v, "step": step}, {"grad_norm": gnorm,
                                                   "lr": lr}
