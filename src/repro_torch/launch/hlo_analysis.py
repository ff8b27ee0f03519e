"""Loop-aware cost analysis over a recorded per-rank op trace (port of
``repro.launch.hlo_analysis``, named after it so that a reader finds it).

The port has no HLO. What it analyses is the stream of aten ops that one
rank dispatches while a step runs: ``OpTrace``, a ``TorchDispatchMode``
that stands beneath ``DTensor``, so that it sees each rank's local ops on
local shapes (a mode above DTensor, such as ``FlopCounterMode``, sees the
global shapes: 2·M·K·N of the whole product). It records every op that
DTensor hands to the rank's tensors, the functional collectives of each
redistribution with the process group they run on, and the kernels'
stand-ins (``OpTrace.record``), and leaves out the ops DTensor runs on fake
global shapes to propagate its metadata. Eager dispatch replays every
loop iteration (layers, microbatches, chunks), so the reference's
multiplication by trip counts comes for free: each iteration is in the
trace. ``OpTrace`` also follows the live bytes of the storages the
traced ops make (``live_bytes``, ``peak_bytes``), which real or fake
tensors alike report.

Cost model (the reference's, ``hlo_analysis.py`` of ``repro.launch``):

  flops   a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, a
          convolution): 2 x output elements x contracted size (``addmm``
          and ``baddbmm`` also add one op an output element); an
          elementwise op: one op an output element; a reduction: one op
          an input element; a kernel's stand-in: its own formula.

  bytes   each op reads its operands and writes its output once. Eager
          has no fusion, so this is the port's real traffic. Views and
          metadata ops (``_FREE_OPS``: views, allocations, device queries,
          waits) move nothing.

  colls   per-rank payload bytes by collective kind, from the
          ``_c10d_functional`` ops (and DTensor's ``shard_dim_alltoall``): all-gather -> output bytes;
          reduce-scatter, all-to-all, broadcast -> operand bytes;
          all-reduce -> 2x operand bytes (reduce and broadcast phases).
          Also grouped by mesh axis (``analyze(trace, axes=...)``: each
          mesh dim's process-group name -> its axis name).

Every number is PER RANK, of the rank the trace ran on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all", "broadcast")

# functional collective (base name) -> kind
_COLL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's own, off the CPU
    "broadcast": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor")

# ops that move no bytes of their own (views, metadata, allocations)
_FREE_OPS = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "t", "transpose",
    "permute", "expand", "expand_as", "slice", "select", "unsqueeze",
    "squeeze", "as_strided", "alias", "detach", "split", "split_with_sizes",
    "unsafe_split", "unbind", "chunk", "narrow", "diagonal", "movedim",
    "unfold", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "resize", "device", "layout", "sym_size", "sym_stride",
    "sym_storage_offset", "sym_numel", "dim", "is_same_size",
    "_local_scalar_dense", "_has_compatible_shallow_copy_type",
    "wait_tensor", "_to_copy_noop",
}

# products: flops from shapes (see _product_flops)
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "convolution"}

# arithmetic: one op an output element (transcendentals more, but noise)
_ARITH_OPS = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "exp",
    "exp2", "log", "log2", "tanh", "rsqrt", "sqrt", "neg", "abs", "sign",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "clamp",
    "clamp_min", "clamp_max", "floor", "ceil", "round", "trunc", "atan2",
    "cos", "sin", "sigmoid", "silu", "gelu", "relu", "expm1", "log1p", "erf",
    "remainder", "fmod", "reciprocal", "lerp", "addcmul", "addcdiv",
    "softplus", "masked_fill", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "silu_backward",
    "gelu_backward", "threshold_backward", "tanh_backward",
    "sigmoid_backward", "softplus_backward", "pow_backward", "floor_divide",
}

# reductions: one op an input element
_REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "cumsum", "cumprod", "prod", "any", "all",
}


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched op: its name (``aten`` base name, ``_c10d_functional``
    base name, or ``kernel:<name>`` for a kernel's stand-in), its tensor
    operands' and outputs' (shape, itemsize), the collective's process
    group, and a stand-in's own flops and bytes."""
    name: str
    namespace: str
    inputs: tuple
    outputs: tuple
    group: str | None = None
    flops: float | None = None
    bytes: float | None = None


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    coll_axis_bytes: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in _COLLECTIVES:
            self.coll_bytes[k] += other.coll_bytes[k] * mult
            self.coll_counts[k] += int(other.coll_counts[k] * mult)
        for k, v in other.coll_axis_bytes.items():
            self.coll_axis_bytes[k] = self.coll_axis_bytes.get(k, 0.0) \
                + v * mult

    @property
    def collective_total(self) -> float:
        return sum(self.coll_bytes.values())

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.bytes,
            "collective_bytes": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "collective_axis_bytes": dict(self.coll_axis_bytes),
            "collective_total_bytes": self.collective_total,
        }


def _sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.element_size()


def _tensors(xs) -> list:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _group_name(args, kwargs) -> str:
    """A functional collective's process-group name (its last argument, a
    name or a group)."""
    g = kwargs.get("group_name", args[-1] if args else None)
    return str(getattr(g, "group_name", g))


# DTensor's own bookkeeping, which a trace keeps out (module, class,
# method): the metadata propagation runs each op once more on fake global
# shapes to read the output's shape, and only the first time an op schema
# is seen; a strided shard's size and offsets are read from a small index
# tensor on the host. Each must be found: ``OpTrace`` raises otherwise.
_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


def _bookkeeping_wrapper(trace: "OpTrace", real):
    def wrapped(*args, **kwargs):
        with trace.paused():
            return real(*args, **kwargs)

    return wrapped


class OpTrace(TorchDispatchMode):
    """Records the ops one rank dispatches, beneath ``DTensor``: an op
    with a ``DTensor`` operand (or any other tensor subclass, such as a
    collective's result awaiting its wait) is handed on
    (``NotImplemented``) to the subclass, whose ops on plain tensors come
    back here. Over meta tensors it traces
    without allocating.

    ``known``: tensors that exist before the trace (the step's
    arguments); their storages are never counted as made by it.
    ``live_bytes`` / ``peak_bytes``: bytes of the storages the traced ops
    made that are alive now / were alive at most at once. A dry run traces
    meta tensors: nothing is allocated, and each storage reports its
    bytes."""

    def __init__(self, known=()):
        super().__init__()
        self.ops: list[Op] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: dict[int, int] = {}
        self._known = {id(t.untyped_storage()) for t in known}
        self._keep = [t.untyped_storage() for t in known]
        self._pause = 0
        self._patched: list = []

    def __enter__(self):
        import importlib
        found = []
        for module, cls, name in _BOOKKEEPING:
            owner = getattr(importlib.import_module(module), cls, None)
            real = owner.__dict__.get(name) if owner is not None else None
            if real is None:
                raise RuntimeError(
                    f"{module}.{cls}.{name} is not in this torch: the "
                    f"trace would count DTensor's bookkeeping as the "
                    f"rank's ops")
            found.append((owner, name, real))
        for owner, name, real in found:
            self._patched.append((owner, name, real))
            setattr(owner, name, _bookkeeping_wrapper(self, real))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for owner, name, real in reversed(self._patched):
                setattr(owner, name, real)
            self._patched.clear()

    @contextlib.contextmanager
    def paused(self):
        """Nothing recorded in the block (ops run all the same)."""
        self._pause += 1
        try:
            yield
        finally:
            self._pause -= 1

    def record(self, name: str, inputs, outputs, *, flops: float,
               bytes_: float) -> None:
        """One op of a kernel's stand-in: its operands and outputs, its
        flops and bytes by its own formula."""
        if self._pause:
            return
        self.ops.append(Op(f"kernel:{name}", "kernel",
                           tuple(_sig(t) for t in _tensors(inputs)),
                           tuple(_sig(t) for t in _tensors(outputs)),
                           flops=float(flops), bytes=float(bytes_)))
        for t in _tensors(outputs):
            self._made(t, ())

    def _made(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen or key in self._known or any(
                id(x.untyped_storage()) == key for x in inputs):
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        if self._seen.pop(key, None) is not None:
            self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._pause:
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return NotImplemented       # DTensor, or a collective's result
            # awaiting its wait: their own dispatch hands the ops back here
        out = func(*args, **kwargs)
        base = func.__name__.split(".")[0]
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        group = _group_name(args, kwargs) \
            if func.namespace in _COLL_NAMESPACES and base in _COLL_KINDS \
            else None
        self.ops.append(Op(base, func.namespace,
                           tuple(_sig(t) for t in ins),
                           tuple(_sig(t) for t in outs), group))
        for t in outs:
            self._made(t, ins)
        return out


def _elems(sig) -> int:
    return math.prod(sig[0])


def _nbytes(sigs) -> float:
    return float(sum(_elems(s) * s[1] for s in sigs))


def _product_flops(op: Op) -> float:
    out = _elems(op.outputs[0])
    if op.name == "convolution":
        w = op.inputs[1][0]                     # (out_ch, in_ch/g, *k)
        return 2.0 * out * math.prod(w[1:])
    lhs = op.inputs[1] if op.name in ("addmm", "baddbmm") else op.inputs[0]
    flops = 2.0 * out * lhs[0][-1]
    if op.name in ("addmm", "baddbmm"):
        flops += out
    return flops


def op_cost(op: Op, axes: dict | None = None) -> Cost:
    """The cost of one recorded op under the model above."""
    cost = Cost()
    if op.flops is not None:                     # a kernel's stand-in
        cost.flops, cost.bytes = op.flops, op.bytes
        return cost
    base = op.name.removesuffix("_") if op.name.endswith("_") \
        and not op.name.startswith("_") else op.name
    if op.namespace in _COLL_NAMESPACES:
        kind = _COLL_KINDS.get(base)
        if kind is None:
            return cost                          # wait_tensor and the like
        opb, outb = _nbytes(op.inputs), _nbytes(op.outputs)
        payload = outb if kind == "all-gather" else \
            2.0 * opb if kind == "all-reduce" else opb
        cost.coll_bytes[kind] += payload
        cost.coll_counts[kind] += 1
        axis = (axes or {}).get(op.group, op.group)
        cost.coll_axis_bytes[str(axis)] = payload
        cost.bytes = opb + outb
        return cost
    if base in _FREE_OPS or op.namespace == "prim":
        return cost
    cost.bytes = _nbytes(op.inputs) + _nbytes(op.outputs)
    if base in _PRODUCTS:
        cost.flops = _product_flops(op)
    elif base in _ARITH_OPS:
        cost.flops = float(sum(_elems(s) for s in op.outputs))
    elif base in _REDUCE_OPS and op.inputs:
        cost.flops = float(_elems(op.inputs[0]))
    # everything else (copies, casts, cat, index, gather, scatter, sort,
    # embedding...): bytes only
    return cost


def analyze(trace, axes: dict | None = None) -> Cost:
    """The whole cost of a recorded trace (an ``OpTrace`` or a list of
    ``Op``), per rank; ``axes`` maps process-group names to mesh axis
    names for ``coll_axis_bytes``."""
    total = Cost()
    for op in getattr(trace, "ops", trace):
        total.add(op_cost(op, axes))
    return total


def analyze_dict(trace, axes: dict | None = None) -> dict:
    return analyze(trace, axes).to_dict()
