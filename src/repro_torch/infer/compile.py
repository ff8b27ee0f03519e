"""Compile/serve split: ``compile(params, cfg, plan) -> CompiledModel``
(port of ``repro.infer.compile``).

Everything decided before the first batch lives in an ``ExecutionPlan``;
compilation is the pass pipeline

    fold_bn  ->  quantize_weights  ->  plan_route_tables  ->  lower

(``route="unpack"`` strips the tables instead of planning routes).

over the folded tree, and the result holds the resolved plan (per-layer
routes filled in). A plan's JSON has the reference's schema, so a plan the
JAX package wrote loads here and replays its routes.

    from repro_torch.infer import ExecutionPlan, compile
    model = compile(params, cfg, ExecutionPlan(weight_dtype="int8",
                                               batch_buckets=(1, 8)))
    logits = model.logits(images_u8)      # on the card

``jit=True`` (the default, as in the reference) lowers the step on the card
to one CUDA graph per bucket (``GraphedStep``), the counterpart of the
reference's one ``jax.jit`` executable per bucket; ``jit=False`` runs it
eagerly. ``compile(..., device="cpu")`` runs every kernel's plain version
on the CPU, eagerly whatever ``jit`` says. ``CompiledModel.profile_step``
times every layer of one eager step. ``replicate_model`` makes the serving
fleet's per-replica copies: shared weights, a graphed step of their own.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import torch

from . import backends as _backends  # noqa: F401  (registers the backends)
from . import registry
from .quant import WEIGHT_DTYPES, map_folded_layers, quantize_folded
from ..core import spikformer
from ..core.spikformer import SpikformerConfig, fold_inference_params
from ..device import (GraphCapturer, StepGraph, graph_launch_counts,
                      resolve_device)
from ..kernels import lut_matmul
from ..kernels._build import on_cpu
from ..kernels.lut_matmul import (RouteConstants, choose_cuda_route,
                                  choose_route)
from ..kernels.spike_matmul import bf16x3_weights, kmajor_weights

ROUTES = ("auto", "unpack", "lut")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything decided before the first batch, as one committable value
    (the reference's fields). ``batch_buckets`` are the batch sizes a step
    runs at; routes are planned once at the largest. ``routes`` maps layer
    paths to "lut" | "lut_sparse" | "unpack"; None decides at compile time,
    a mapping pins the decisions (what a loaded plan carries)."""
    backend: str = "packed_cuda"
    weight_dtype: str | None = None     # None: whatever the tree carries
    batch_buckets: tuple[int, ...] = (8,)
    max_table_bytes: int = lut_matmul.MAX_TABLE_BYTES
    route: str = "auto"                 # "auto" | "unpack" | "lut"
    route_constants: RouteConstants = dataclasses.field(
        default_factory=RouteConstants)
    routes: dict | None = None
    layer_occupancy: dict | None = None
    backend_options: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.route not in ROUTES:
            raise ValueError(f"unknown route {self.route!r}; "
                             f"expected one of {ROUTES}")
        if (self.weight_dtype is not None
                and self.weight_dtype not in WEIGHT_DTYPES):
            raise ValueError(f"unknown weight_dtype {self.weight_dtype!r}; "
                             f"expected one of {WEIGHT_DTYPES}")
        buckets = tuple(sorted({int(b) for b in self.batch_buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"batch_buckets must be >= 1, got "
                             f"{self.batch_buckets!r}")
        object.__setattr__(self, "batch_buckets", buckets)
        if isinstance(self.route_constants, dict):
            object.__setattr__(self, "route_constants",
                               RouteConstants.from_dict(self.route_constants))
        if self.layer_occupancy is not None:
            occ = {}
            for path, o in self.layer_occupancy.items():
                o = float(o)
                if not 0.0 <= o <= 1.0:
                    raise ValueError(f"layer_occupancy[{path!r}] = {o!r}; "
                                     "occupancy is a fraction in [0, 1]")
                occ[str(path)] = o
            object.__setattr__(self, "layer_occupancy", occ)

    @property
    def plan_batch(self) -> int:
        """The bucket route planning keys its (M, K, N, G) shapes on."""
        return self.batch_buckets[-1]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_buckets"] = list(self.batch_buckets)
        return d

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown ExecutionPlan keys {sorted(bad)}; "
                             f"expected a subset of {sorted(known)}")
        d = dict(d)
        if "batch_buckets" in d:
            d["batch_buckets"] = tuple(d["batch_buckets"])
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# The pass pipeline
# ---------------------------------------------------------------------------

def fold_bn(params, cfg: SpikformerConfig, *, folded: bool = False):
    """Pass 1: training params -> {kernel, bias} inference tree;
    ``folded=True`` passes a pre-folded (possibly quantized) tree through."""
    return params if folded else fold_inference_params(params, cfg)


def quantize_weights(tree, weight_dtype: str | None):
    """Pass 2: returns ``(tree, resolved_dtype)``. None keeps what the tree
    carries; "float32" on an int8 tree fails loudly."""
    if weight_dtype is not None and weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"unknown weight_dtype {weight_dtype!r}; "
                         f"expected one of {WEIGHT_DTYPES}")
    already_quantized = "scale" in tree["scs"]["conv0"]
    if weight_dtype == "float32" and already_quantized:
        raise ValueError("weight_dtype='float32' requested but the folded "
                         "tree is already int8-quantized")
    if weight_dtype == "int8" and not already_quantized:
        tree = quantize_folded(tree)
    return tree, ("int8" if weight_dtype == "int8" or already_quantized
                  else "float32")


def layer_shape(cfg: SpikformerConfig, path: str, batch_size: int) -> tuple:
    """The packed-route matmul shape ``(m, live planes, groups)`` the step
    gives the layer at ``path`` at ``batch_size``: what route planning
    keys on. conv0 is SSSC, its 8 value planes in one group."""
    t = cfg.timesteps
    g = -(-t // 8)
    if path.startswith("scs/conv"):
        i = int(path.removeprefix("scs/conv"))
        m = batch_size * (cfg.img_size // 2 ** (i + 1)) ** 2
        return (m, 8, 1) if i == 0 else (m, t, g)
    return batch_size * cfg.tokens, t, g


def plan_route_tables(folded, cfg: SpikformerConfig, *, batch_size: int,
                      max_table_bytes: int = lut_matmul.MAX_TABLE_BYTES,
                      build_tables: bool = True,
                      constants: RouteConstants | None = None,
                      routes: dict | None = None,
                      layer_occupancy: dict | None = None,
                      force: str | None = None, cpu_branch: bool = False):
    """Pass 3: per-layer route planning. For each layer, the matmul shape
    (M, K, N, G) the step sees at ``batch_size`` goes to
    ``choose_cuda_route``, or with ``cpu_branch`` (a ``packed`` backend on
    its CPU branch) to the reference's ``choose_route``, which weighs the
    zero-chunk-skipping gather where ``layer_occupancy`` holds the layer's
    calibration (or ``force`` pins one route everywhere, or a pinned
    ``routes`` mapping is replayed); LUT layers get their (C, 256, N)
    table built once into a ``lut`` leaf (a True flag with
    ``build_tables=False``), and unpack layers their tensor-core operand
    (``with_kmajor``: int8 layers their K-major copy, f32 layers on the
    card their bf16 split; none with ``build_tables=False`` or on the CPU
    branch, which never reads it).
    A "lut_sparse" route needs its calibrated occupancy, as in the
    reference; the kernels run it as the dense gather, bitwise the same.
    Returns ``(annotated_tree, routes)``."""
    occ_map = layer_occupancy or {}
    plan = {}
    choose = choose_route if cpu_branch else choose_cuda_route

    def annotate(path, layer):
        wq = layer["kernel"]
        if routes is None:
            m, tt, gg = layer_shape(cfg, path, batch_size)
            k, n = wq.shape
            route = force or choose(
                m=m, k=k, n=n, g=gg, t=tt,
                weights_are_int=lut_matmul.is_int_kernel(wq),
                max_table_bytes=max_table_bytes, constants=constants,
                occupancy=occ_map.get(path))
        else:
            if path not in routes:
                raise ValueError(f"pinned route plan has no entry for layer "
                                 f"{path!r}: it was built for another config")
            route = routes[path]
            if route not in ("lut", "lut_sparse", "unpack"):
                raise ValueError(f"pinned route {route!r} for {path!r}; "
                                 "expected 'lut', 'lut_sparse' or 'unpack'")
        if route == "lut_sparse" and occ_map.get(path) is None:
            raise ValueError(f"route 'lut_sparse' for {path!r} requires a "
                             "calibrated occupancy in layer_occupancy")
        plan[path] = route
        layer = {k2: v for k2, v in layer.items()
                 if k2 not in _OPERAND_LEAVES}
        if route in ("lut", "lut_sparse"):
            layer["lut"] = lut_matmul.build_lut(wq) if build_tables else True
        elif build_tables and not cpu_branch:
            layer = with_kmajor(path, layer)
        return layer

    return map_folded_layers(folded, annotate), plan


def with_kmajor(path: str, layer: dict) -> dict:
    """An unpack-routed layer with the B operand of its tensor-core dot,
    built once here and never per call: ``kernel_kmajor``, the (N, K)
    K-major copy of an int8 kernel, or ``kernel_bf16x3``, the (3, N, K)
    three-term bf16 split of an f32 kernel, the latter only where the
    kernel lies on the card (on the CPU the wrapper runs the plain f32
    dot, which never reads it). The split must hold every weight exactly,
    or this raises, naming the layer. conv0 (its SSSC runs the shift-sum
    dot in f32) gets neither."""
    kernel = layer["kernel"]
    if path == "scs/conv0":
        return layer
    if kernel.dtype == torch.int8:
        return {**layer, "kernel_kmajor": kmajor_weights(kernel)}
    if kernel.dtype != torch.float32 or on_cpu(kernel):
        return layer
    return {**layer, "kernel_bf16x3": bf16x3_weights(kernel,
                                                     name=f"layer {path}")}


_OPERAND_LEAVES = ("lut", "kernel_kmajor", "kernel_bf16x3")


def strip_lut_annotations(folded):
    """Remove every ``lut``, ``kernel_kmajor`` and ``kernel_bf16x3`` leaf:
    what ``route="unpack"`` uses to pin the unpack route even on a tree a
    previous planner annotated."""
    return map_folded_layers(folded, lambda _, l: {
        k: v for k, v in l.items() if k not in _OPERAND_LEAVES})


def linear_layer_paths(cfg: SpikformerConfig) -> list:
    """Layer paths in forward-call order: the order one ``forward_folded``
    pass reaches each spiking linear (``map_folded_layers`` walks the same
    paths in tree order)."""
    paths = [f"scs/conv{i}" for i in range(len(cfg.scs_channels))]
    for i in range(cfg.depth):
        paths += [f"blocks/b{i}/ssa/{w}" for w in ("wq", "wk", "wv", "wo")]
        paths += [f"blocks/b{i}/mlp/fc1", f"blocks/b{i}/mlp/fc2"]
    return paths


def calibrate_layer_occupancy(params, cfg: SpikformerConfig, images_u8, *,
                              folded: bool = False,
                              weight_dtype: str | None = None,
                              device=None) -> dict:
    """Per-layer chunk occupancy of a calibration batch: one eager forward
    on ``device`` (default: the card) through ``backends.OccupancyRecorder``
    (the CPU branch's dense routes, noting before each spiking linear the
    fraction of nonzero chunk-index bytes in its input), zipped with
    ``linear_layer_paths``. The result is the ``layer_occupancy`` mapping
    an ``ExecutionPlan`` commits: measured, JSON-serializable, replayable."""
    device = resolve_device(device)
    tree = to_device(fold_bn(params, cfg, folded=folded), device)
    tree, _ = quantize_weights(tree, weight_dtype)
    if isinstance(images_u8, np.ndarray):
        images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
    recorder = _backends.OccupancyRecorder()
    lower(tree, cfg, recorder, jit=False)(
        tree, images_u8.to(device=device, dtype=torch.uint8))
    paths = linear_layer_paths(cfg)
    if len(recorder.trace) != len(paths):
        raise RuntimeError(
            f"occupancy trace has {len(recorder.trace)} entries but the "
            f"config has {len(paths)} spiking linears")
    return dict(zip(paths, recorder.trace))


def sparse_occupancy(plan: ExecutionPlan) -> dict | None:
    """The calibrated occupancy of the layers ``plan`` routed "lut_sparse":
    what the step closes over (``lower``), None when there are none."""
    occ = plan.layer_occupancy or {}
    return {p: occ[p] for p, r in (plan.routes or {}).items()
            if r == "lut_sparse"} or None


def profile_layer_paths(cfg: SpikformerConfig) -> list:
    """Every timed op of one profiled forward, in call order: the spiking
    linears with each block's STDP attention (``blocks/b{i}/ssa/stdp``)
    where ``forward_folded`` calls it. The two-layer MLP is assumed: the
    profiling backend exposes no ``mlp_pair_lif``."""
    paths = [f"scs/conv{i}" for i in range(len(cfg.scs_channels))]
    for i in range(cfg.depth):
        paths += [f"blocks/b{i}/ssa/{w}" for w in ("wq", "wk", "wv")]
        paths += [f"blocks/b{i}/ssa/stdp", f"blocks/b{i}/ssa/wo"]
        paths += [f"blocks/b{i}/mlp/fc1", f"blocks/b{i}/mlp/fc2"]
    return paths


class _LayerTimer:
    """A backend wrapper that times every dataflow layer between two
    barriers (``sync``: ``torch.cuda.synchronize`` on the card), so a
    layer's time is its own, not its neighbours' queue. Appends ``(t0,
    t1)`` to ``trace`` in forward-call order. It exposes no
    ``mlp_pair_lif``, so the two-layer MLP runs and the op sequence is
    ``profile_layer_paths``. Bookkeeping ops (residual, to_tokens, rate)
    run untimed."""

    def __init__(self, inner, *, clock=time.perf_counter, sync=lambda: None):
        self._inner = inner
        self._clock = clock
        self._sync = sync
        self.trace: list[tuple] = []

    def _timed(self, fn, *args, **kw):
        self._sync()
        t0 = self._clock()
        out = fn(*args, **kw)
        self._sync()
        self.trace.append((t0, self._clock()))
        return out

    def sssc_lif(self, *args, **kw):
        return self._timed(self._inner.sssc_lif, *args, **kw)

    def zsc_lif(self, *args, **kw):
        return self._timed(self._inner.zsc_lif, *args, **kw)

    def wssl_lif(self, *args, **kw):
        return self._timed(self._inner.wssl_lif, *args, **kw)

    def stdp_lif(self, *args, **kw):
        return self._timed(self._inner.stdp_lif, *args, **kw)

    def residual(self, *args, **kw):
        return self._inner.residual(*args, **kw)

    def to_tokens(self, *args, **kw):
        return self._inner.to_tokens(*args, **kw)

    def rate(self, *args, **kw):
        return self._inner.rate(*args, **kw)


class GraphedStep:
    """``jit=True``: the eager step ``fwd`` over ``folded`` replayed as one
    CUDA graph per batch size, captured at first use (``warmup`` captures
    every bucket). A capture first runs the step once eagerly on the
    step's own side stream, so kernels are built, their attributes set and
    the step's constants made before anything records; the buckets share
    one graph memory pool. A call copies the images into the bucket's
    static input, replays its graph and returns a clone of its logits,
    which the next replay would overwrite. A capture that fails raises and
    names the op; nothing then runs eagerly in its place. On the CPU the
    step runs eagerly.

    The graphs hold the addresses of the tree's tensors and of their own
    pool: the kernels' TMA descriptors, encoded on the host at capture,
    point there. That is right because the tree's weights, tables and
    K-major copies never move and the pool replays the same addresses;
    ``folded`` must be the tree the step was lowered over.

    Serving threads. A step's static input, logits and pool are its own,
    so two threads must never replay one ``GraphedStep`` at once: each
    replica of a fleet gets a step of its own (``replicate_model``), and a
    lock plus an event make calls from several threads (a health probe
    beside the replica's worker) take turns, each call's stream waiting for
    the previous call's work. Captures are safe while other threads serve:
    they go through a ``device.GraphCapturer`` of the step's own (a
    process-wide lock, the thread-local capture mode, the capturing
    thread's launches only, a side stream the step holds alone)."""

    def __init__(self, fwd, folded):
        self._fwd = fwd
        self.folded = folded
        self.device = folded["head"]["kernel"].device
        self.graphs: dict[int, StepGraph] = {}
        self._capture = GraphCapturer(self.device)
        self._lock = threading.Lock()
        self._done = None           # event after the last call's work

    @property
    def _stream(self):
        """The side stream this step's captures hold (None before the
        first)."""
        return self._capture.stream

    def capture(self, shape) -> StepGraph:
        shape = tuple(int(d) for d in shape)
        static_in = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        graph, out, launches = self._capture(
            lambda: self._fwd(self.folded, static_in),
            f"the batch-{shape[0]} step")
        self.graphs[shape[0]] = StepGraph(graph, static_in, out, launches)
        return self.graphs[shape[0]]

    def __call__(self, folded_tree, images):
        if folded_tree is not self.folded:
            raise ValueError("a graphed step replays the tree it was lowered "
                             "over; lower again for another tree")
        if self.device.type != "cuda":
            return self._fwd(folded_tree, images.to(self.device))
        with self._lock:
            bucket = self.graphs.get(images.shape[0])
            if bucket is None:
                bucket = self.capture(images.shape)
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            logits = bucket.replay(images)
            with torch.inference_mode():
                out = logits.clone()
            self._done = stream.record_event()
            return out

    def launch_counts(self) -> dict:
        """Kernel launches the replays made since the last reset: each
        bucket's captured launches times its replays."""
        return graph_launch_counts(self.graphs.values())

    def reset_launch_counts(self) -> None:
        for g in self.graphs.values():
            g.replays = 0


def lower(folded, cfg: SpikformerConfig, backend, *, jit: bool = True,
          layer_occupancy: dict | None = None):
    """Pass 4: the annotated tree becomes one step callable: eager with
    ``jit=False``, else a ``GraphedStep`` (one CUDA graph per bucket on the
    card, eager on the CPU). Callers that wrap the backend to record or
    time each layer pass ``jit=False``: a replay runs no Python.
    ``layer_occupancy`` (``sparse_occupancy`` of the plan) is closed over,
    as the reference keeps the sparse budgets static. The CPU branch's
    sparse gather decides dense or sparse by a host read, so a ``packed``
    backend with ``pallas=False`` on the card runs eagerly (``jit=False``):
    a graph capture would raise at that read."""
    def fwd(folded_tree, images):
        with torch.inference_mode():
            return spikformer.forward_folded(folded_tree, images, cfg,
                                             backend=backend,
                                             layer_occupancy=layer_occupancy)
    return GraphedStep(fwd, folded) if jit else fwd


def to_device(tree, device):
    """Every tensor of a nested dict moved to ``device``; other leaves (the
    planner's True flags) pass through."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# compile() and its result
# ---------------------------------------------------------------------------

def plan_chunks(n: int, buckets) -> list:
    """Split ``n`` rows into bucket-shaped steps, minimizing padded rows and
    then step count: whole largest buckets first, the remainder solved
    exactly over the bucket set. Returns ``[(rows, bucket), ...]``."""
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets!r}")
    chunks = []
    bmax = buckets[-1]
    while n >= bmax:
        chunks.append((bmax, bmax))
        n -= bmax
    if n == 0:
        return chunks
    best = {0: (0, 0, None)}            # rows left -> (pad, steps, bucket)
    for r in range(1, n + 1):
        best[r] = min((best[r - min(b, r)][0] + b - min(b, r),
                       best[r - min(b, r)][1] + 1, b)
                      for b in buckets)
    while n:
        b = best[n][2]
        chunks.append((min(b, n), b))
        n -= min(b, n)
    return chunks


class CompiledModel:
    """A Spikformer lowered under an ``ExecutionPlan`` onto one device.
    ``plan`` is the resolved plan (``weight_dtype`` concrete, ``routes``
    filled in), whose JSON replays this compilation. ``jit`` is how the
    step was lowered: one CUDA graph per bucket on the card, or eager."""

    def __init__(self, *, cfg, backend, folded, plan: ExecutionPlan, fwd,
                 device: torch.device, jit: bool = True):
        self.cfg = cfg
        self.backend = backend
        self.folded = folded
        self.plan = plan
        self.device = device
        self.jit = jit
        self._fwd = fwd
        self.buckets = plan.batch_buckets

    # -- shapes ---------------------------------------------------------------

    @property
    def batch_size(self) -> int:
        """The largest bucket (the planning shape)."""
        return self.buckets[-1]

    @property
    def weight_dtype(self) -> str:
        return self.plan.weight_dtype

    def input_shape(self, bucket: int | None = None):
        c = self.cfg
        b = self.batch_size if bucket is None else bucket
        return (b, c.img_size, c.img_size, c.in_channels)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` rows (the largest bucket when
        none does: the caller chunks)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def plan_chunks(self, n: int) -> list:
        return plan_chunks(n, self.buckets)

    # -- execution ------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _images(self, images_u8) -> torch.Tensor:
        """numpy or tensor images as a uint8 tensor: on the model's device
        for an eager step; a graphed step takes host images as they are
        and copies them into its static input itself."""
        if isinstance(images_u8, np.ndarray):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        images_u8 = images_u8.to(dtype=torch.uint8)
        if isinstance(self._fwd, GraphedStep):
            return images_u8
        return images_u8.to(self.device)

    def warmup(self) -> float:
        """Run every bucket once on zeros (capturing its graph under
        ``jit``); returns seconds."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self._fwd(self.folded, torch.zeros(self.input_shape(b),
                                               dtype=torch.uint8,
                                               device=self.device))
        self._sync()
        return time.perf_counter() - t0

    def step(self, images_u8) -> torch.Tensor:
        """One step; images (numpy or tensor) must already be a whole
        bucket. Returns (bucket, classes) f32 logits on the model's
        device, a tensor of their own."""
        if images_u8.shape[0] not in self.buckets:
            raise ValueError(
                f"batch of {images_u8.shape[0]} is not a bucket "
                f"{self.buckets}; pad to one (the engine does this)")
        return self._fwd(self.folded, self._images(images_u8))

    def logits(self, images_u8) -> torch.Tensor:
        """(N, H, W, C) uint8, any N >= 1 -> (N, classes) f32, dispatched
        in bucket-shaped chunks whose pad rows are dropped."""
        images_u8 = self._images(images_u8)
        outs, i = [], 0
        for rows, b in self.plan_chunks(images_u8.shape[0]):
            chunk = images_u8[i:i + rows]
            if b > rows:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (b - rows, *chunk.shape[1:]))])
            outs.append(self.step(chunk)[:rows])
            i += rows
        return torch.cat(outs)

    def classify(self, images_u8) -> torch.Tensor:
        """(N, H, W, C) uint8 -> (N,) int32 argmax class ids."""
        return self.logits(images_u8).argmax(dim=-1).to(torch.int32)

    def graph_launch_counts(self) -> dict:
        """Kernel launches made by graph replays since the last reset (the
        wrappers' counters tick only when a step runs or is captured)."""
        if isinstance(self._fwd, GraphedStep):
            return self._fwd.launch_counts()
        return {}

    def reset_graph_launch_counts(self) -> None:
        if isinstance(self._fwd, GraphedStep):
            self._fwd.reset_launch_counts()

    # -- profiling ------------------------------------------------------------

    def profile_step(self, images_u8=None, *, tracer=None,
                     clock=time.perf_counter) -> list:
        """Per-layer times of one eager forward, each op between two
        barriers (``torch.cuda.synchronize`` on the card). One row per
        ``profile_layer_paths`` entry::

            {"path": "blocks/b0/ssa/wq", "route": "lut", "seconds": 1.3e-4,
             "occupancy": None}

        ``route`` is the resolved plan's decision ("stdp" for attention,
        "unpack" where the plan holds none); ``occupancy`` the plan's
        calibrated chunk occupancy or None. Images default to zeros at the
        largest bucket; a batch that is not a bucket raises. The rows are
        relative weights of eager ops, not a prediction of the graphed
        step. With a ``tracer`` (any object with ``enabled`` and
        ``span(category, name, **kw)``), each row is also a ``("layer",
        path)`` span."""
        if images_u8 is None:
            images_u8 = torch.zeros(self.input_shape(), dtype=torch.uint8)
        if images_u8.shape[0] not in self.buckets:
            raise ValueError(
                f"profile batch of {images_u8.shape[0]} is not a bucket "
                f"{self.buckets}; profiling times the shapes serving runs")
        images = self._images(images_u8).to(self.device)
        timer = _LayerTimer(self.backend, clock=clock, sync=self._sync)
        lower(self.folded, self.cfg, timer, jit=False,
              layer_occupancy=sparse_occupancy(self.plan))(self.folded,
                                                           images)
        self._sync()
        paths = profile_layer_paths(self.cfg)
        if len(timer.trace) != len(paths):
            raise RuntimeError(
                f"layer-timing trace has {len(timer.trace)} entries but the "
                f"config has {len(paths)} timed ops")
        routes = self.plan.routes or {}
        occ_all = self.plan.layer_occupancy or {}
        rows = []
        for path, (t0, t1) in zip(paths, timer.trace):
            occ = occ_all.get(path)
            default = "stdp" if path.endswith("/stdp") else "unpack"
            rows.append({"path": path, "route": routes.get(path, default),
                         "seconds": t1 - t0, "occupancy": occ})
            if tracer is not None and tracer.enabled:
                tracer.span("layer", path, t0=t0, t1=t1, occupancy=occ,
                            value=t1 - t0)
        return rows

    def __call__(self, images_u8):
        return self.logits(images_u8)


def compile(params, cfg: SpikformerConfig, plan: ExecutionPlan | None = None,
            *, folded: bool = False, device=None, jit: bool = True,
            **plan_overrides) -> CompiledModel:
    """Run the pass pipeline under ``plan`` on ``device`` (default: the
    card) and return a ``CompiledModel``. ``params`` is a training tree
    unless ``folded=True`` (a ``fold_inference_params`` tree, possibly
    quantized or annotated). ``jit`` lowers the step to one CUDA graph per
    bucket on the card (``GraphedStep``; the CPU runs eagerly either way).
    ``plan_overrides`` are ``dataclasses.replace`` fields on the plan. A
    plan the reference wrote runs as ``registry.port_backend`` maps its
    backend, and the resolved plan names the port's backend."""
    plan = ExecutionPlan() if plan is None else plan
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    name, options = registry.port_backend(plan.backend, plan.backend_options)
    if (name, options) != (plan.backend, plan.backend_options):
        plan = dataclasses.replace(plan, backend=name,
                                   backend_options=options)
    device = resolve_device(device)
    # the head dot and the plain routes must run in full f32 on the card:
    # TF32 keeps ~3 decimal digits and would break parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    backend = registry.get_backend(plan.backend, device=device,
                                   **plan.backend_options)
    spec = registry.backend_spec(plan.backend)
    tables = registry.wants_lut_tables(plan.backend, backend)
    # a packed backend on the reference's CPU branch plans by its chooser
    cpu_branch = getattr(backend, "pallas", True) is False

    def check_dtype(dtype):
        if dtype not in spec.weight_dtypes:
            raise ValueError(f"backend {spec.name!r} does not support "
                             f"weight_dtype {dtype!r}")

    if plan.weight_dtype is not None:
        check_dtype(plan.weight_dtype)
    tree = to_device(fold_bn(params, cfg, folded=folded), device)
    tree, weight_dtype = quantize_weights(tree, plan.weight_dtype)
    check_dtype(weight_dtype)

    if plan.route in ("auto", "lut"):
        tree, routes = plan_route_tables(
            tree, cfg, batch_size=plan.plan_batch,
            max_table_bytes=plan.max_table_bytes,
            build_tables=tables,
            constants=plan.route_constants, routes=plan.routes,
            layer_occupancy=plan.layer_occupancy,
            force="lut" if plan.route == "lut" else None,
            cpu_branch=cpu_branch)
    else:
        tree = strip_lut_annotations(tree)
        if tables and not cpu_branch:
            tree = map_folded_layers(tree, with_kmajor)
        routes = {}

    resolved = dataclasses.replace(plan, weight_dtype=weight_dtype,
                                   routes=routes)
    return CompiledModel(cfg=cfg, backend=backend, folded=tree, plan=resolved,
                         fwd=lower(tree, cfg, backend, jit=jit,
                                   layer_occupancy=sparse_occupancy(resolved)),
                         device=device, jit=jit)


def replicate_model(model: CompiledModel, *, device=None) -> CompiledModel:
    """A data-parallel serving copy of a compiled model — the fleet's
    per-replica plumbing (port of ``repro.infer.compile.replicate_model``).

    The RESOLVED ``ExecutionPlan`` is shared verbatim: replicas of one
    fleet run the same plan by construction (routes are already pinned in
    ``model.plan.routes``). With ``device=None`` the copy shares the folded
    tree, so thread-backed replicas on one card pay no extra weight memory,
    but it gets a step lowered anew: a ``GraphedStep`` owns its static
    buffers and graph pool, which two replicas replaying at once would
    overwrite for each other (where a jit executable in the reference can
    be shared). With a ``device``, the tree is moved there first."""
    folded = model.folded if device is None else to_device(
        model.folded, resolve_device(device))
    dev = folded["head"]["kernel"].device
    return CompiledModel(cfg=model.cfg, backend=model.backend, folded=folded,
                         plan=model.plan, device=dev, jit=model.jit,
                         fwd=lower(folded, model.cfg, model.backend,
                                   jit=model.jit,
                                   layer_occupancy=sparse_occupancy(
                                       model.plan)))
