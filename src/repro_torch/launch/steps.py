"""Step programs: the train, prefill and serve (decode) steps for any
ported ArchConfig (port of ``repro.launch.steps``).

The train step accumulates gradients over microbatches, so the full-vocab
logits only ever exist for one microbatch at a time. Gradients come from
``torch.autograd.grad`` over the parameter leaves, the port's
``jax.value_and_grad`` (as ``core/spikformer.py:value_and_grad``). The loss
runs ``lm_loss(..., flash=False)``: the reference's chunked softmax, its
own training formulation, since the flash kernel has no backward.

The reference's ``jit_*`` functions wrap these steps in XLA sharding (in
and out shardings over a mesh, donated buffers); they come with the port
of ``repro.sharding``. Here every step runs on the device its inputs lie
on.
"""
from __future__ import annotations

import dataclasses

import torch

from ..nn import transformer as T
from ..nn.module import map_with_path, tree_paths
from ..optim import adamw
from ..optim.compression import ef_compress, ef_init


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatch: int = 32          # rows per accumulation step
    compression: str = "none"     # none | int8 | topk
    accum_dtype: str = "float32"  # grad accumulator; bf16 for the >=100B
    # configs, where an f32 copy of the grads would not fit beside them
    opt: adamw.OptConfig = dataclasses.field(default_factory=adamw.OptConfig)


def opt_config(cfg, ts: TrainSettings) -> adamw.OptConfig:
    """``ts.opt`` with the moments stored in ``cfg.opt_state_dtype``."""
    return dataclasses.replace(
        ts.opt, state_dtype=T.as_dtype(cfg.opt_state_dtype))


def microbatch(name: str, value, start: int, stop: int):
    """Rows ``start:stop`` of one batch value: on dim 1 of
    ``mrope_positions`` (3, B, S), as the reference's ``mrope_split``
    cuts it, on dim 0 of every other value."""
    return value[:, start:stop] if name == "mrope_positions" \
        else value[start:stop]


def make_train_step(cfg, ts: TrainSettings):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``, the metrics 0-d tensors.

    The global batch (B rows) splits into ``accum = B // micro``
    microbatches as the reference's reshape does: row ``j * micro + i`` is
    row i of microbatch j (``microbatch``). Each microbatch's gradients
    are added, in order, into an ``accum_dtype`` accumulator, then divided
    by ``accum``; the loss is the microbatches' sum over ``accum``. With
    compression on, ``opt_state["ef"]`` holds the error feedback and the
    gradients pass through ``ef_compress`` before AdamW."""
    T.require_ported(cfg)
    opt_cfg = opt_config(cfg, ts)
    acc_dt = T.as_dtype(ts.accum_dtype)

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        micro = min(ts.microbatch, b)
        if b % micro:
            raise ValueError(f"a global batch of {b} rows does not split "
                             f"into microbatches of {micro}")
        accum = b // micro
        leaves = {p: t.detach().requires_grad_() for p, t in
                  tree_paths(params)}
        tracked = map_with_path(lambda p, _: leaves[p], params)
        gsum = {p: torch.zeros(t.shape, dtype=acc_dt, device=t.device)
                for p, t in leaves.items()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for j in range(accum):
            mbatch = {k: microbatch(k, v, j * micro, (j + 1) * micro)
                      for k, v in batch.items()}
            with torch.enable_grad():
                loss, _ = T.lm_loss(tracked, mbatch, cfg, flash=False)
                grads = torch.autograd.grad(
                    loss, list(leaves.values()), allow_unused=True)
            for p, g in zip(leaves, grads):
                if g is not None:
                    gsum[p].add_(g.to(acc_dt))
            lsum = lsum + loss.detach()
        grads = map_with_path(lambda p, _: gsum[p] / accum, params)
        loss = lsum / accum

        opt = {k: v for k, v in opt_state.items() if k != "ef"}
        if ts.compression != "none":
            grads, new_ef = ef_compress(grads, opt_state["ef"],
                                        method=ts.compression)
        new_params, new_opt, metrics = adamw.update(grads, opt, params,
                                                    opt_cfg)
        if ts.compression != "none":
            new_opt["ef"] = new_ef
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill(cfg):
    """``prefill(params, batch) -> (logits, cache)``: a fresh bf16 cache
    the prompt's length, filled from position 0; the logits of the last
    position. (The reference's ``shape`` argument, a dry-run
    ``ShapeSpec``, is not ported: the batch gives the shape.)"""
    def prefill(params, batch):
        b, s = batch["tokens"].shape
        cache = T.init_cache(cfg, b, s, device=batch["tokens"].device)
        logits, new_cache, _ = T.model_apply(
            params, dict(batch, cache_pos=0), cfg, mode="prefill",
            cache=cache)
        return logits, new_cache
    return prefill


def make_serve_step(cfg):
    """``serve_step(params, cache, batch) -> (token, cache)``: one decode
    step at ``batch["cache_pos"]``, the greedy next token of each row."""
    def serve_step(params, cache, batch):
        logits, new_cache, _ = T.model_apply(
            params, batch, cfg, mode="decode", cache=cache)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return token, new_cache
    return serve_step


# ---------------------------------------------------------------------------
# shapes without values
# ---------------------------------------------------------------------------

def abstract_params(cfg, seed: int = 0):
    """``init_model``'s tree as meta tensors: its shapes and dtypes,
    nothing allocated or drawn."""
    with torch.device("meta"):
        return T.init_model(torch.Generator().manual_seed(seed), cfg,
                            device="meta")


def abstract_opt_state(cfg, params_shapes, ts: TrainSettings):
    """The optimizer state's tree (and the error feedback's, with
    compression on) as meta tensors."""
    st = adamw.init(params_shapes, opt_config(cfg, ts))
    if ts.compression != "none":
        st = dict(st, ef=ef_init(params_shapes))
    return st
