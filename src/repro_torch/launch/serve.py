"""LM serving: per-request prefill and continuous-batching decode (port of
``repro.launch.serve``).

The engine keeps a fixed pool of ``slots`` (the decode batch); each slot
holds one request's cache rows (KV caches, linear or ring, and SSM states).
A request's prompt is prefilled alone into the engine's one-row cache (its
attention runs the flash kernel where no window cuts it), the row is
spliced into the pool, and one decode step advances every slot by one
token per iteration, each row at its own position.

``jit=True`` (the default, as the reference jits both halves of its
engine) replays them as CUDA graphs on the card: decode as one graph,
prefill as one graph per prompt length. ``jit=False`` runs them eagerly.

    python -m repro_torch.launch.serve --arch smollm-360m [--reduce] \\
        [--slots 4 --requests 8 --prompt-len 32 --max-new 16] \\
        [--mesh DATA,MODEL]

With ``--mesh`` the engine serves over a ``(DATA, MODEL)`` mesh
(``launch.mesh.make_cpu_mesh`` over the initialised world, a one-rank
group if there is none): params by ``rules.param_shardings``, the slot
pool and the row cache by ``rules.cache_shardings`` (the KV sequence over
the model axis, the slots over dp), each decode step writing every row at
its own position into the sharded pool.

``--arch`` takes each ported config the reference's engine serves:
smollm-360m, stablelm-12b, glm4-9b, hymba-1.5b, mamba2-130m, qwen2-vl-7b
(as a text model: no image embeddings, and RoPE, which is M-RoPE with
three equal streams), and qwen1.5-110b and the MoE configs
qwen3-moe-30b-a3b and arctic-480b with ``--reduce`` only. An
encoder-decoder config
(whisper-large-v3) raises: the engine takes no frames, as the
reference's does not. Their full widths do not fit one
card: qwen3-moe's f32 params (its config's ``param_dtype``) take 122 GB
of the card's 80 (in bf16 weights, 61 GB, it is served by
``chip_smoke.py``, which replaces the config's ``param_dtype``),
qwen1.5-110b's take 222 GB in its bf16 (``chip_smoke.py`` serves it cut
to 16 of its 80 layers through ``launch.steps``' sharded steps), and
arctic's 477B params take 954 GB even in its bf16.

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from collections import deque

import torch

from ..configs.base import get_config
from ..device import (GraphCapturer, StepGraph, graph_launch_counts,
                      resolve_device)
from ..nn import transformer as T
from ..sharding import rules
from . import steps


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


# cache leaves a decode step reads and advances (not idempotent)
RECURRENT = ("ssm", "conv")


def cache_leaves(cache):
    """``(name, tensor)`` for every leaf of a cache (a dict of stacked
    leaves or a per-layer list of dicts), depth first, in a fixed order."""
    if isinstance(cache, list):
        for layer in cache:
            yield from cache_leaves(layer)
    elif isinstance(cache, dict):
        for name, leaf in cache.items():
            if isinstance(leaf, torch.Tensor):
                yield name, leaf
            else:
                yield from cache_leaves(leaf)


class Engine:
    """Continuous-batching engine over a static slot pool.

    ``params`` (for example a reference tree carried across by
    ``repro_torch.weights.lm_from_reference``) default to ``init_model`` of
    a generator on the engine's device seeded with ``seed``. Defaults follow
    the reference: the config's compute dtype (bf16) and a bf16 cache.
    ``flash=False`` runs the plain attention in prefill too.

    ``jit=True`` (the default) on the card, the counterpart of the
    reference's ``jax.jit`` of both bodies:

    - decode is one CUDA graph, captured at the first decode, with a static
      (slots, 2) int64 input (column 0 the tokens, column 1 the positions:
      one copy fills both) and a static (slots,) argmax output. The slot
      pool is the graph's storage, the counterpart of the reference's
      donation: it is written in place and never rebound, so the graph's
      addresses stay its own. Free slots go on decoding token 0 at
      positions that may pass ``cache_len``, as in the reference; a
      linear cache's write drops them on the device, a ring's wraps into
      the free slot's own rows (a splice overwrites the slot whole).
    - prefill is one graph per prompt length, jax.jit's own cache key:
      each length is captured the first time it is seen and replayed after
      that, so a new length costs a capture as a new shape costs a compile
      in JAX. No padding: the first token comes from the last position.
      Its static input is the (1, S) tokens, its storage the engine's one
      row cache, which the body resets to what ``init_cache`` makes (zeros,
      positions -1, zero SSM states and conv windows), so a short prompt
      after a long one leaves no stale slot marked valid and no state. Kernel 7's TMA descriptors are encoded on the
      host at capture from that moment's pointers and frozen into the
      graph: right because q comes from the graph's pool and k, v from the
      row cache, at the same addresses on every replay of a length
      (``_tma_ready``'s copy, where it makes one, is a captured copy into
      the pool too).

    A capture first runs the body once eagerly on the engine's side stream
    with the real inputs (the step is repeated by the replay that follows,
    which writes the same KV values; the SSM states and conv windows that
    the warm-up advanced are put back first), so kernels are built and
    their attributes set before anything records. A capture that fails raises
    and names the op; nothing then runs eagerly in its place. Each replay
    is followed by one read of its argmax, the step's synchronisation.

    All of an engine's graphs share one memory pool, although prefill
    graphs are captured at any time and replayed in any order between
    decode replays. That is safe because every tensor that lives across
    replays lies outside the pool (the static inputs, the row cache, the
    slot pool, all made before their capture) or is read before another
    graph replays (the argmax outputs): a later capture may place its
    tensors where an earlier graph keeps its temporaries.

    On the CPU ``jit`` is recorded and the engine runs eagerly.

    ``mesh`` (a ``DeviceMesh`` with axes ``("data", "model")``, on the
    engine's device type): the engine serves over it, as the reference's
    serves under its mesh. Params are placed by ``rules.param_shardings``
    (on one rank a leaf is kept as it is, not copied), the slot pool and
    the row cache are made shard by shard by ``rules.cache_shardings``
    (``steps.sharded_cache``: KV sequence over the model axis, slots over
    dp), both bodies run under ``steps._on(mesh)``, the decode's tokens
    and positions are placed as ``jit_serve_step`` places its batch, and
    each decode step writes every row at its own position into the
    sharded pool (``nn/attention.py:_cache_update_sharded``). A splice
    copies the row cache into the slot on the ranks that hold that slot.
    With ``jit`` on the card the decode is captured as without a mesh: on
    one rank every redistribution is the identity and no collective runs;
    a capture that cannot hold raises and names the op, as any capture
    does, and the caller passes ``jit=False``."""

    def __init__(self, cfg, *, slots: int, cache_len: int, seed: int = 0,
                 params=None, compute_dtype=None,
                 cache_dtype=torch.bfloat16, device=None,
                 flash: bool = True, jit: bool = True, mesh=None):
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the engine serves text prompts and takes no "
                "encoder frames, as the reference's Engine takes none (its "
                "prefill fails on the missing batch['frames']); drive an "
                "encoder-decoder model through model_apply")
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.compute_dtype = T.as_dtype(compute_dtype or cfg.compute_dtype)
        self.cache_dtype = cache_dtype
        self.flash = flash
        self.jit = jit
        # calls replay CUDA graphs (jit on the card); else they run eagerly
        self.graphed = jit and self.device.type == "cuda"
        self.mesh = mesh
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_model(gen, cfg, device=self.device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot serve "
                                 f"an engine on {self.device}")
            params = rules.place_tree(params,
                                      rules.param_shardings(mesh, params))
            meta = {"tokens": torch.empty((slots, 1), dtype=torch.int64,
                                          device="meta"),
                    "cache_pos": torch.empty((slots,), dtype=torch.int64,
                                             device="meta")}
            self._batch_sh = rules.batch_shardings(mesh, meta)
        self.params = params
        self.pool = self._new_cache(slots)
        self.row = self._new_cache(1)
        # ("prefill", S) or ("decode", slots) -> its graph, under jit
        self.graphs: dict[tuple, StepGraph] = {}
        self._capture = GraphCapturer(self.device)
        self.active: dict[int, Request] = {}           # slot -> request
        self.positions = [0] * slots                    # per-slot cache_pos
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.decode_step_s: list[float] = []            # host clock, synced

    def _new_cache(self, batch: int):
        """A fresh cache of ``batch`` rows: ``init_cache``'s, or over the
        mesh each rank's shard of it."""
        if self.mesh is None:
            return T.init_cache(self.cfg, batch, self.cache_len,
                                dtype=self.cache_dtype, device=self.device)
        return steps.sharded_cache(self.cfg, self.mesh, batch,
                                   self.cache_len, dtype=self.cache_dtype,
                                   device=self.device)

    def _sharded(self):
        """The mesh active for a body (nothing without one)."""
        return steps._on(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()

    # -- the step bodies: no host read, no pageable copy, no new cache ------

    def _prefill_body(self, tokens):
        """tokens: (1, S) -> (1,) argmax of the last position; the prompt's
        cache in ``self.row``, every leaf of it (KV, positions, SSM state,
        conv window) reset first to a fresh ``init_cache``."""
        for name, leaf in cache_leaves(self.row):
            leaf.fill_(-1 if name == "positions" else 0)
        with self._sharded():
            logits, _, _ = T.model_apply(
                self.params, {"tokens": tokens, "cache_pos": 0}, self.cfg,
                mode="prefill", cache=self.row,
                compute_dtype=self.compute_dtype, flash=self.flash)
            return rules.full_value(logits[:, -1]).argmax(-1)

    def _decode_body(self, inputs):
        """inputs: (slots, 2), the tokens and each slot's cache position ->
        (slots,) argmax. One step advances every slot, each row at its own
        offset, writing the pool in place."""
        batch = {"tokens": inputs[:, :1], "cache_pos": inputs[:, 1]}
        with self._sharded():
            if self.mesh is not None:
                batch = steps._place_batch(batch, self._batch_sh)
            logits, _, _ = T.model_apply(
                self.params, batch, self.cfg, mode="decode", cache=self.pool,
                compute_dtype=self.compute_dtype, flash=self.flash)
            return rules.full_value(logits[:, -1]).argmax(-1)

    # -- graphed or eager calls --------------------------------------------

    def _run(self, key: tuple, body, inputs: torch.Tensor) -> list:
        """``body`` on the host tensor ``inputs``: eagerly, or by replaying
        the graph of ``key``, captured first if new. Returns the argmax as
        a list, the step's one read."""
        if not self.graphed:
            return body(inputs.to(self.device)).tolist()
        g = self.graphs.get(key)
        if g is None:
            g = self._new_graph(key, body, inputs)
        return g.replay(inputs).tolist()

    def _new_graph(self, key: tuple, body, inputs: torch.Tensor):
        static_in = inputs.to(self.device)
        # the capture's warm-up run advances the recurrent state it reads
        # (SSM states, conv windows; a KV write is the same twice): put it
        # back, so that the first replay starts where the step should
        saved = [(leaf, leaf.clone()) for name, leaf in cache_leaves(
            self.pool) if name in RECURRENT] if key[0] == "decode" else []
        graph, out, launches = self._capture(
            lambda: body(static_in),
            f"the {key[0]} step of shape {tuple(inputs.shape)}")
        for leaf, before in saved:
            leaf.copy_(before)
        self.graphs[key] = StepGraph(graph, static_in, out, launches)
        return self.graphs[key]

    def prefill(self, prompt: list[int]) -> int:
        """The prompt's first new token; its cache is left in ``self.row``."""
        tokens = torch.tensor([prompt], dtype=torch.int64)
        return self._run(("prefill", len(prompt)), self._prefill_body,
                         tokens)[0]

    def decode(self, tokens: list[int], positions: list[int]) -> list[int]:
        """One decode step of every slot: ``tokens[s]`` at cache position
        ``positions[s]``; returns each slot's next token."""
        inputs = torch.tensor(list(zip(tokens, positions)),
                              dtype=torch.int64)
        return self._run(("decode", self.slots), self._decode_body, inputs)

    def graph_launch_counts(self) -> dict:
        """Kernel launches made by graph replays since the last reset (the
        wrappers' counters tick only on eager runs and captures)."""
        return graph_launch_counts(self.graphs.values())

    def reset_graph_launch_counts(self) -> None:
        for g in self.graphs.values():
            g.replays = 0

    # -- pool management ---------------------------------------------------

    def _splice(self, slot: int):
        """Copy the row cache into pool slot ``slot``, in place, clearing
        what the slot held. The batch axis follows the cache's layout, as
        in the reference, not its shapes: axis 1 of stacked (L, B, ...)
        leaves, axis 0 of a per-layer list's (B, ...) leaves. Over a mesh,
        each rank that holds the slot copies its shard of the row (the
        pool and the row share their sequence layout), the others
        nothing."""
        axis = 0 if isinstance(self.pool, list) else 1
        for (_, leaf), (_, row) in zip(cache_leaves(self.pool),
                                       cache_leaves(self.row)):
            if self.mesh is None:
                leaf.select(axis, slot).copy_(row.select(axis, 0))
            else:
                _splice_sharded(leaf, row, axis, slot)

    def submit(self, req: Request):
        req.t_arrival = time.perf_counter()
        self.queue.append(req)

    def _admit(self):
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            req.out.append(self.prefill(req.prompt))
            req.t_first = time.perf_counter()
            self._splice(slot)
            self.positions[slot] = len(req.prompt)
            self.active[slot] = req

    def step(self) -> int:
        """One engine iteration; returns the number of active slots."""
        self._admit()
        if not self.active:
            return 0
        tokens = [0] * self.slots
        for slot, req in self.active.items():
            tokens[slot] = req.out[-1]
        t0 = time.perf_counter()
        toks = self.decode(tokens, self.positions)
        self.decode_step_s.append(time.perf_counter() - t0)
        self.positions = [p + 1 for p in self.positions]
        finished = []
        for slot, req in self.active.items():
            req.out.append(toks[slot])
            if len(req.out) >= req.max_new:
                req.t_done = time.perf_counter()
                finished.append(slot)
        for slot in finished:
            self.done.append(self.active.pop(slot))
        return len(self.active)

    def run(self):
        while self.queue or self.active:
            self.step()
        return self.done


def _splice_sharded(leaf, row, axis: int, slot: int) -> None:
    """Pool leaf ``leaf`` (a DTensor, its batch axis ``axis`` over dp or
    whole) takes the row cache's ``row`` (batch 1, replicated over dp) at
    ``slot``, under ``local_map`` on the ranks whose batch rows hold it."""
    from torch.distributed.tensor.experimental import local_map
    mesh = leaf.device_mesh
    dims = [i for i, pl in enumerate(leaf.placements) if pl.is_shard(axis)]

    def local(dst, src):
        b0 = 0
        for d in dims:
            b0 = b0 * mesh.size(d) + mesh.get_local_rank(d)
        b0 *= dst.shape[axis]
        if b0 <= slot < b0 + dst.shape[axis]:
            dst.select(axis, slot - b0).copy_(src.select(axis, 0))

    local_map(local, out_placements=None,
              in_placements=(tuple(leaf.placements), tuple(row.placements)),
              device_mesh=mesh, redistribute_inputs=False)(leaf, row)


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summary(done, wall_s: float, decode_step_s) -> dict:
    """Host-clock serving figures of one run."""
    total = sum(len(r.out) for r in done)
    ttfts = [r.t_first - r.t_arrival for r in done]
    return {
        "requests": len(done),
        "total_new_tokens": total,
        "wall_s": wall_s,
        "tok_per_s": total / wall_s,
        "mean_ttft_s": sum(ttfts) / len(ttfts),
        "decode_steps": len(decode_step_s),
        "decode_step_p50_s": _percentile(decode_step_s, 0.5),
        "decode_step_p95_s": _percentile(decode_step_s, 0.95),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: serve over a mesh of that shape "
                         "(default: no mesh)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    with _serving_mesh(args.mesh, args.device) as mesh:
        return _serve(args, cfg, mesh)


@contextlib.contextmanager
def _serving_mesh(spec, device):
    """The mesh ``--mesh DATA,MODEL`` names (``train.mesh_shape``), None
    without it: over the initialised world, else over a group this opens
    (one rank through a ``HashStore`` for 1,1; a launcher's group, as
    ``train.main`` opens it, for more) and destroys after."""
    if spec is None:
        yield None
        return
    import os
    import torch.distributed as dist
    from ..device import resolve_device
    from .mesh import make_cpu_mesh
    from .train import mesh_shape
    shape = mesh_shape(spec)
    own = not dist.is_initialized()
    if own and shape != (1, 1):
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        yield make_cpu_mesh(*shape, device=device)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, cfg, mesh):
    eng = Engine(cfg, slots=args.slots, cache_len=args.cache_len,
                 seed=args.seed, device=args.device, mesh=mesh)
    gen = torch.Generator().manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (args.prompt_len,),
                               generator=gen).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    done = eng.run()
    wall = time.perf_counter() - t0
    out = {"arch": cfg.name, "device": str(eng.device),
           "mesh": None if mesh is None else list(mesh.shape),
           **summary(done, wall, eng.decode_step_s)}
    if eng.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(eng.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
