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

``compile(..., device="cpu")`` runs every kernel's plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from . import backends as _backends  # noqa: F401  (registers the backends)
from . import registry
from .quant import WEIGHT_DTYPES, map_folded_layers, quantize_folded
from ..core import spikformer
from ..core.spikformer import SpikformerConfig, fold_inference_params
from ..device import resolve_device
from ..kernels import lut_matmul
from ..kernels.lut_matmul import RouteConstants, choose_cuda_route
from ..kernels.spike_matmul import kmajor_weights

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


def plan_route_tables(folded, cfg: SpikformerConfig, *, batch_size: int,
                      max_table_bytes: int = lut_matmul.MAX_TABLE_BYTES,
                      build_tables: bool = True,
                      constants: RouteConstants | None = None,
                      routes: dict | None = None,
                      layer_occupancy: dict | None = None,
                      force: str | None = None):
    """Pass 3: per-layer route planning. For each layer, the matmul shape
    (M, K, N, G) the step sees at ``batch_size`` goes to
    ``choose_cuda_route`` (or ``force`` pins one route everywhere, or a
    pinned ``routes`` mapping is replayed); LUT layers get their
    (C, 256, N) table built once into a ``lut`` leaf (a True flag with
    ``build_tables=False``), and int8 unpack layers their K-major copy
    (``with_kmajor``; none with ``build_tables=False``). A pinned
    "lut_sparse" needs its calibrated
    occupancy, as in the reference, and runs the dense gather here.
    Returns ``(annotated_tree, routes)``."""
    t = cfg.timesteps
    g = -(-t // 8)
    occ_map = layer_occupancy or {}
    plan = {}

    def shapes_for(path):
        """Packed-route matmul shape (m, live planes, groups) at ``path``."""
        if path.startswith("scs/conv"):
            i = int(path.removeprefix("scs/conv"))
            m = batch_size * (cfg.img_size // 2 ** (i + 1)) ** 2
            return (m, 8, 1) if i == 0 else (m, t, g)   # conv0 is SSSC
        return batch_size * cfg.tokens, t, g

    def annotate(path, layer):
        wq = layer["kernel"]
        if routes is None:
            m, tt, gg = shapes_for(path)
            k, n = wq.shape
            route = force or choose_cuda_route(
                m=m, k=k, n=n, g=gg, t=tt,
                weights_are_int=lut_matmul.is_int_kernel(wq),
                max_table_bytes=max_table_bytes, constants=constants)
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
                 if k2 not in ("lut", "kernel_kmajor")}
        if route in ("lut", "lut_sparse"):
            layer["lut"] = lut_matmul.build_lut(wq) if build_tables else True
        elif build_tables:
            layer = with_kmajor(path, layer)
        return layer

    return map_folded_layers(folded, annotate), plan


def with_kmajor(path: str, layer: dict) -> dict:
    """An unpack-routed layer with its ``kernel_kmajor`` leaf: the (N, K)
    K-major copy of an int8 kernel, the B operand of the int8 tensor-core
    dot, built once here and never per call. f32 kernels and conv0 (its
    SSSC runs the shift-sum dot in f32) get none."""
    if path == "scs/conv0" or layer["kernel"].dtype != torch.int8:
        return layer
    return {**layer, "kernel_kmajor": kmajor_weights(layer["kernel"])}


def strip_lut_annotations(folded):
    """Remove every ``lut`` and ``kernel_kmajor`` leaf: what
    ``route="unpack"`` uses to pin the unpack route even on a tree a
    previous planner annotated."""
    return map_folded_layers(folded, lambda _, l: {
        k: v for k, v in l.items() if k not in ("lut", "kernel_kmajor")})


def lower(folded, cfg: SpikformerConfig, backend):
    """Pass 4: the annotated tree becomes one eager step callable."""
    def fwd(folded_tree, images):
        with torch.inference_mode():
            return spikformer.forward_folded(folded_tree, images, cfg,
                                             backend=backend)
    return fwd


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
    filled in), whose JSON replays this compilation."""

    def __init__(self, *, cfg, backend, folded, plan: ExecutionPlan, fwd,
                 device: torch.device):
        self.cfg = cfg
        self.backend = backend
        self.folded = folded
        self.plan = plan
        self.device = device
        self._fwd = fwd
        self.buckets = plan.batch_buckets

    @property
    def batch_size(self) -> int:
        """The largest bucket (the planning shape)."""
        return self.buckets[-1]

    def input_shape(self, bucket: int | None = None):
        c = self.cfg
        b = self.batch_size if bucket is None else bucket
        return (b, c.img_size, c.img_size, c.in_channels)

    def plan_chunks(self, n: int) -> list:
        return plan_chunks(n, self.buckets)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> float:
        """Run every bucket once on zeros; returns seconds."""
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
        device."""
        if images_u8.shape[0] not in self.buckets:
            raise ValueError(
                f"batch of {images_u8.shape[0]} is not a bucket "
                f"{self.buckets}; pad to one (the engine does this)")
        if isinstance(images_u8, np.ndarray):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        return self._fwd(self.folded, images_u8.to(self.device, torch.uint8))

    def logits(self, images_u8) -> torch.Tensor:
        """(N, H, W, C) uint8, any N >= 1 -> (N, classes) f32, dispatched
        in bucket-shaped chunks whose pad rows are dropped."""
        if isinstance(images_u8, np.ndarray):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        images_u8 = images_u8.to(self.device, torch.uint8)
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


def compile(params, cfg: SpikformerConfig, plan: ExecutionPlan | None = None,
            *, folded: bool = False, device=None,
            **plan_overrides) -> CompiledModel:
    """Run the pass pipeline under ``plan`` on ``device`` (default: the
    card) and return a ``CompiledModel``. ``params`` is a training tree
    unless ``folded=True`` (a ``fold_inference_params`` tree, possibly
    quantized or annotated). ``plan_overrides`` are ``dataclasses.replace``
    fields on the plan."""
    plan = ExecutionPlan() if plan is None else plan
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    device = resolve_device(device)
    # the head dot and the plain routes must run in full f32 on the card:
    # TF32 keeps ~3 decimal digits and would break parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    backend = registry.get_backend(plan.backend, device=device,
                                   **plan.backend_options)
    spec = registry.backend_spec(plan.backend)

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
            build_tables=spec.wants_lut_tables,
            constants=plan.route_constants, routes=plan.routes,
            layer_occupancy=plan.layer_occupancy,
            force="lut" if plan.route == "lut" else None)
    else:
        tree = strip_lut_annotations(tree)
        if spec.wants_lut_tables:
            tree = map_folded_layers(tree, with_kmajor)
        routes = {}

    resolved = dataclasses.replace(plan, weight_dtype=weight_dtype,
                                   routes=routes)
    return CompiledModel(cfg=cfg, backend=backend, folded=tree, plan=resolved,
                         fwd=lower(tree, cfg, backend), device=device)
