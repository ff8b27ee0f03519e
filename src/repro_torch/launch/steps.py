"""Step programs: the train, prefill and serve (decode) steps for any
ported ArchConfig (port of ``repro.launch.steps``).

The train step accumulates gradients over microbatches, so the full-vocab
logits only ever exist for one microbatch at a time. Gradients come from
``torch.autograd.grad`` over the parameter leaves, the port's
``jax.value_and_grad`` (as ``core/spikformer.py:value_and_grad``). The loss
runs ``lm_loss(..., flash=False)``: the reference's chunked softmax, its
own training formulation, since the flash kernel has no backward.

``jit_train_step``, ``jit_serve_step`` and ``jit_prefill`` are the
reference's sharded builders: each returns the step, its abstract inputs
(meta tensors) and its input shardings (``sharding.rules``). The step
places its inputs by those shardings as ``DTensor``s on the mesh (a rank
keeps its own shard of a full tensor; a DTensor is redistributed), runs
eagerly on them with the mesh active (``sharding.set_mesh``: the model's
``shard_hint`` calls pin the reference's activation layouts) and returns
its outputs in the reference's output layouts. Plain tensors that the
model makes on the way (positions, masks) count as replicated
(``implicit_replication``). Nothing is compiled: the reference's ``jit``
is the XLA program, here DTensor dispatch runs op by op. Donation
(``donate_argnums``) has no counterpart: the inputs stay valid.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..nn import transformer as T
from ..nn.module import map_with_path, tree_paths
from ..optim import adamw
from ..optim.compression import ef_compress, ef_init
from ..sharding import rules
from ..sharding.compat import set_mesh
from ..sharding.hints import shard_hint


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
    cuts it, on dim 0 of every other value. Under a mesh the rows are
    laid out over dp again (a DTensor's slice of its sharded batch dim
    comes back whole on every rank, and the loss would then take the
    whole microbatch's vocab-wide scores on each)."""
    if name == "mrope_positions":
        return shard_hint(value[:, start:stop], None, "dp", None)
    return shard_hint(value[start:stop], "dp", *(None,) * (value.dim() - 1))


def make_train_step(cfg, ts: TrainSettings):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``, the metrics 0-d tensors.

    With DTensor params, the gradient accumulator is kept in the params'
    layout (``zeros_like``), each microbatch's gradients redistributed
    into it before they are added (the reference's ``constrain``).

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
        gsum = {p: torch.zeros_like(t, dtype=acc_dt)
                for p, t in leaves.items()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for j in range(accum):
            mbatch = {k: microbatch(k, v, j * micro, (j + 1) * micro)
                      for k, v in batch.items()}
            lsum = lsum + accumulate(tracked, leaves, gsum, mbatch, cfg)
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


def accumulate(tracked, leaves: dict, gsum: dict, mbatch, cfg):
    """One microbatch of the train step: the gradients of its loss with
    respect to ``leaves`` (path -> leaf; ``tracked`` is the tree of them)
    added, in each accumulator's layout and dtype, into ``gsum``; returns
    the loss, detached. (``launch/dryrun.py`` traces this per
    microbatch.)"""
    with torch.enable_grad():
        loss, _ = T.lm_loss(tracked, mbatch, cfg, flash=False)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is not None:
            gsum[p].add_(_constrain(g, gsum[p]).to(gsum[p].dtype))
    return loss.detach()


def _constrain(g, like):
    """A gradient in its accumulator's layout (a plain tensor as it is)."""
    if not isinstance(g, DTensor) or tuple(g.placements) == \
            tuple(like.placements):
        return g
    return g.redistribute(like.device_mesh, like.placements)


def make_prefill(cfg, cache_len: int | None = None):
    """``prefill(params, batch) -> (logits, cache)``: a fresh bf16 cache
    the prompt's length (or ``cache_len`` slots, room for the decode
    steps after it), filled from position 0; the logits of the last
    position. (The reference's ``shape`` argument, a dry-run
    ``ShapeSpec``, is not ported: the batch gives the shape.)"""
    def prefill(params, batch):
        b, s = batch["tokens"].shape
        cache = T.init_cache(cfg, b, cache_len or s,
                             device=batch["tokens"].device)
        logits, new_cache, _ = T.model_apply(
            params, dict(batch, cache_pos=0), cfg, mode="prefill",
            cache=cache)
        return logits, new_cache
    return prefill


def make_serve_step(cfg):
    """``serve_step(params, cache, batch) -> (token, cache)``: one decode
    step at ``batch["cache_pos"]``, the greedy next token of each row (on
    DTensors, of the gathered last logits: DTensor's argmax over a
    sharded vocab fails on a batch it does not split)."""
    def serve_step(params, cache, batch):
        logits, new_cache, _ = T.model_apply(
            params, batch, cfg, mode="decode", cache=cache)
        token = torch.argmax(rules.full_value(logits[:, -1]),
                             dim=-1).to(torch.int32)
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


# ---------------------------------------------------------------------------
# sharded builders
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _on(mesh):
    """The mesh active, and the model's plain tensors replicated."""
    with set_mesh(mesh), implicit_replication():
        yield


def _place_batch(batch, shardings):
    """The batch placed by ``shardings``; ``cache_pos`` (the reference's
    traced 0-d scalar) taken as the host int it stands for."""
    out = {}
    for k, v in batch.items():
        if k == "cache_pos" and (isinstance(v, int) or v.dim() == 0):
            out[k] = int(v)
        else:
            out[k] = rules.place(v, shardings[k])
    return out


def jit_train_step(cfg, mesh, ts: TrainSettings, batch_shapes: dict):
    """The train step over ``mesh`` (a ``DeviceMesh``): params and
    optimizer state in their FSDP x TP storage layout, the batch over dp.
    Returns ``(step, (params_shapes, opt_shapes, batch_shapes),
    in_shardings)``; the step returns params and state in their input
    layouts and the metrics replicated."""
    p_sh = abstract_params(cfg)
    o_sh = abstract_opt_state(cfg, p_sh, ts)
    in_sh = (rules.param_shardings(mesh, p_sh),
             rules.opt_state_shardings(mesh, o_sh),
             rules.batch_shardings(mesh, batch_shapes))
    rep = rules.NamedSharding(mesh, rules.P())
    inner = make_train_step(cfg, ts)

    def step(params, opt_state, batch):
        params = rules.place_tree(params, in_sh[0])
        opt_state = rules.place_tree(opt_state, in_sh[1])
        batch = _place_batch(batch, in_sh[2])
        with _on(mesh):
            new_p, new_o, metrics = inner(params, opt_state, batch)
            new_p = rules.place_tree(new_p, in_sh[0])
            new_o = rules.place_tree(new_o, in_sh[1])
            metrics = {k: rules.place(v, rep) for k, v in metrics.items()}
        return new_p, new_o, metrics

    return step, (p_sh, o_sh, batch_shapes), in_sh


def jit_serve_step(cfg, mesh, cache_shapes, batch_shapes):
    """One decode step over ``mesh``: params in their storage layout, the
    cache by ``rules.cache_shardings`` (KV sequence over the model axis,
    written in place), the batch over dp. Returns ``(step, (params_shapes,
    cache_shapes, batch_shapes), in_shardings)``; the step returns the
    tokens (B,) over dp and the cache in its layout. A plain cache passed
    in is placed as a new DTensor tree: pass the returned one to the next
    step."""
    p_sh = abstract_params(cfg)
    c_sh = rules.cache_shardings(mesh, cache_shapes)
    in_sh = (rules.param_shardings(mesh, p_sh), c_sh,
             rules.batch_shardings(mesh, batch_shapes))
    b = batch_shapes["tokens"].shape[0]
    tok_sh = rules.batch_shardings(
        mesh, {"t": torch.empty((b,), dtype=torch.int32, device="meta")})["t"]
    inner = make_serve_step(cfg)

    def step(params, cache, batch):
        params = rules.place_tree(params, in_sh[0])
        cache = rules.place_tree(cache, in_sh[1])
        batch = _place_batch(batch, in_sh[2])
        with torch.no_grad(), _on(mesh):
            token, new_cache = inner(params, cache, batch)
            token = rules.place(token, tok_sh)
        return token, new_cache

    return step, (p_sh, cache_shapes, batch_shapes), in_sh


def _cache_fill(path: str) -> int:
    """``init_cache``'s value of a leaf: -1 for positions, else 0."""
    return -1 if path.endswith("positions") else 0


def sharded_cache(cfg, mesh, batch: int, length: int,
                  dtype=torch.bfloat16, device=None):
    """``init_cache``'s tree laid out by ``rules.cache_shardings`` over
    ``mesh``, each rank making only its shard (zeros, positions -1) on
    ``device``."""
    shapes = T.init_cache(cfg, batch, length, dtype=dtype, device="meta")
    return rules.new_sharded(shapes, rules.cache_shardings(mesh, shapes),
                             _cache_fill, device)


def jit_prefill(cfg, mesh, batch_shapes, cache_len: int | None = None):
    """The prefill over ``mesh``: a fresh cache laid out by
    ``rules.cache_shardings`` (``cache_len`` slots, default the prompt's
    length; each rank makes only its shard), filled by
    each rank's shard, with the flash kernel run per
    rank on its local heads. Returns ``(prefill, (params_shapes,
    batch_shapes), in_shardings)``; the prefill returns the logits of the
    last position (layout unconstrained, as the reference's ``None``) and
    the cache in its layout."""
    p_sh = abstract_params(cfg)
    in_sh = (rules.param_shardings(mesh, p_sh),
             rules.batch_shardings(mesh, batch_shapes))
    b, s = batch_shapes["tokens"].shape
    cache_shapes = T.init_cache(cfg, b, cache_len or s, device="meta")
    c_sh = rules.cache_shardings(mesh, cache_shapes)

    def prefill(params, batch):
        params = rules.place_tree(params, in_sh[0])
        batch = _place_batch(batch, in_sh[1])
        cache = rules.new_sharded(cache_shapes, c_sh, _cache_fill,
                                  batch["tokens"].device)
        with torch.no_grad(), _on(mesh):
            logits, new_cache, _ = T.model_apply(
                params, dict(batch, cache_pos=0), cfg, mode="prefill",
                cache=cache)
        return logits, new_cache

    return prefill, (p_sh, batch_shapes), in_sh
