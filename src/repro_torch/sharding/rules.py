"""Path-based sharding rules: parameter paths -> PartitionSpecs (port of
``repro.sharding.rules``).

Storage layout is FSDP x TP (ZeRO-3 style): 2-D weights shard their input
dim over the data(+pod) axes and their output dim over the model axis;
MoE expert tensors shard the expert dim over data(+pod) (expert
parallelism) and the hidden dim over model. Rules match on path
*suffixes* and specify trailing dims only: stacked-layer leading dims
(L, ...) are padded with None, so the same table covers stacked and
per-layer trees. A spec is a ``P`` (a tuple, equal as one to the
reference's ``PartitionSpec``); ``NamedSharding(mesh, spec)`` turns it
into ``torch.distributed.tensor`` placements on the mesh's
``DeviceMesh`` (an axis group such as ``("pod", "data")`` is ``Shard(d)``
on each of its mesh dims, pod-major as in the reference) and places a
tensor there (``place``).

The rule functions take a ``DeviceMesh``, an ``AbstractMesh``
(``compat.abstract_mesh``) or any object with ``.axis_names`` and a
name -> size ``.shape``.

A serving fleet's replicas need only the 1-D ``data`` axis over the
host's devices (``serving_mesh``, ``replica_devices``): the list of CUDA
devices ``torch.cuda.device_count()`` reports.
"""
from __future__ import annotations

import math
import re

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..nn.module import map_with_path, tree_paths
from .compat import abstract_mesh, as_abstract  # noqa: F401  (re-export)


def serving_mesh(devices=None) -> list:
    """The devices a serving fleet replicates over, in order: ``devices``
    as given, else every CUDA device of the host, else the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        devices = devices or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("serving_mesh needs at least one device")
    return devices


def replica_devices(n: int, mesh=None) -> list:
    """Device assignment for ``n`` data-parallel serving replicas: replica
    ``i`` serves from device ``i % len(mesh)`` (``mesh``: a device list,
    default ``serving_mesh()``).

    On a single-device host every entry is ``None``: the fleet's
    thread-backed mode, where replicas share the one device and its
    weights (each still with a step of its own; see
    ``repro_torch.infer.compile.replicate_model``)."""
    if n < 1:
        raise ValueError(f"need n >= 1 replicas, got {n!r}")
    devs = serving_mesh(mesh)
    if len(devs) <= 1:
        return [None] * n
    return [devs[i % len(devs)] for i in range(n)]


# ---------------------------------------------------------------------------
# the FSDP x TP rule table
# ---------------------------------------------------------------------------


class P(tuple):
    """A PartitionSpec: one entry a tensor dim, each None (replicated), an
    axis name or a tuple of axis names; dims past its length replicate."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def dp_axes(mesh):
    """The data-parallel axis group: ('pod','data') on multi-pod meshes."""
    return ("pod", "data") if "pod" in as_abstract(mesh).axis_names \
        else ("data",)


def placements(mesh, spec) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``: ``Shard(d)`` on each mesh dim that tensor dim d names, in
    mesh order, ``Replicate()`` on the others. A mesh dim of size 1 is
    ``Replicate()`` whatever the spec: it holds the same data either way,
    and DTensor's view rules refuse to fold a sharded dim even when it has
    one shard."""
    am = as_abstract(mesh)
    out = [Replicate()] * len(am.axis_names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            i = am.axis_names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            if am.axis_sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """``spec`` over ``mesh`` (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def __repr__(self):
        return f"NamedSharding({as_abstract(self.mesh)!r}, {self.spec!r})"


def device_mesh_of(mesh):
    dm = as_abstract(mesh).device_mesh
    if dm is None:
        raise ValueError(f"{mesh!r} has no devices: place tensors on a "
                         "DeviceMesh (launch.mesh.make_cpu_mesh)")
    return dm


def local_slices(shape, sharding: NamedSharding) -> tuple:
    """This rank's shard of a tensor of ``shape`` laid out by
    ``sharding``: one ``slice`` a dim (a dim that two mesh dims split is
    cut by each in turn, mesh order, so pod-major)."""
    dm = device_mesh_of(sharding.mesh)
    coord = dm.get_coordinate()
    start, size = [0] * len(shape), list(shape)
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard) and dm.size(i) > 1:
            size[pl.dim] //= dm.size(i)
            start[pl.dim] += coord[i] * size[pl.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def from_shard(local: torch.Tensor, sharding: NamedSharding, shape,
               stride=None) -> DTensor:
    """The ``DTensor`` of global ``shape`` (and ``stride``, default
    contiguous) whose shard on this rank is ``local`` (the part
    ``local_slices`` names), moved to the mesh's device type if it is not
    there (a meta tensor stays meta, as in ``DTensor.from_local``: a dry
    run's shapes); nothing is sent between ranks."""
    dm = device_mesh_of(sharding.mesh)
    if not local.is_meta:
        local = local.to(dm.device_type)
    local = local.contiguous()
    if stride is None:
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, dm, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x``, a full tensor on this rank, as a ``DTensor`` laid out by
    ``sharding``: each rank keeps its own shard (a copy of that slice;
    ``x`` itself where nothing is split), and nothing is sent between
    ranks. A ``DTensor`` is redistributed instead."""
    if isinstance(x, DTensor):
        want = sharding.placements
        if tuple(x.placements) == want:
            return x
        if len({pl.reduce_op for pl in x.placements if pl.is_partial()}) > 1:
            x = reduce_partials(x)
        return x.redistribute(device_mesh_of(sharding.mesh), want)
    return from_shard(x[local_slices(x.shape, sharding)], sharding, x.shape,
                      x.stride())


def new_sharded(shapes, shardings, fill, device):
    """A tree of ``DTensor``s of ``shapes`` (a tree of tensors; meta
    tensors will do) laid out by ``shardings``, each rank making only its
    own shard on ``device``, filled with ``fill(path)``: nothing is sent
    between ranks and no rank holds a whole leaf (on the meta device,
    nothing is allocated)."""
    flat = dict(tree_paths(shardings))

    def one(path, t):
        sh = flat[path]
        local = [s.stop - s.start for s in local_slices(t.shape, sh)]
        return from_shard(torch.full(local, fill(path), dtype=t.dtype,
                                     device=device), sh, t.shape)

    return map_with_path(one, shapes)


def reduce_partials(x):
    """``x`` with every partial value reduced, one mesh dim at a time (a
    plain tensor as it is): a loss's mean over dp and its sum over the
    vocab's shards are partial values of two kinds, which torch 2.11's
    DTensor neither adds nor reduces in one step."""
    if not isinstance(x, DTensor):
        return x
    for i, pl in enumerate(x.placements):
        if pl.is_partial():
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if j == i else q
                for j, q in enumerate(x.placements)))
    return x


def place_tree(tree, shardings):
    """``place`` over a tree and its tree of shardings."""
    flat = dict(tree_paths(shardings))
    return map_with_path(lambda p, x: place(x, flat[p]), tree)


def full_value(x):
    """The whole value of a ``DTensor`` on every rank (a plain tensor as
    it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# (regex on path, spec builder over (dp,)) — first match wins
_RULES = [
    (r"embed/embedding$",              lambda dp: ("model", dp)),
    (r"head/kernel$",                  lambda dp: (dp, "model")),
    (r"(wq|wk|wv)/kernel$",            lambda dp: (dp, "model")),
    (r"wo/kernel$",                    lambda dp: ("model", dp)),
    (r"(gate|up)/kernel$",             lambda dp: (dp, "model")),
    (r"down/kernel$",                  lambda dp: ("model", dp)),
    (r"moe/router$",                   lambda dp: (dp, None)),
    (r"moe/w_(gate|up)$",              lambda dp: (dp, None, "model")),
    (r"moe/w_down$",                   lambda dp: (dp, "model", None)),
    (r"ssm/in_proj$",                  lambda dp: (dp, None)),
    (r"ssm/out_proj$",                 lambda dp: (None, dp)),
]


def _axes_size(am, ax) -> int:
    return math.prod(am.shape[a] for a in
                     (ax if isinstance(ax, tuple) else (ax,)))


def spec_for(path: str, shape: tuple, mesh) -> P:
    am = as_abstract(mesh)
    dp = dp_axes(am)
    dp = dp if len(dp) > 1 else dp[0]
    for pat, builder in _RULES:
        if re.search(pat, path):
            trailing = builder(dp)
            lead = (None,) * (len(shape) - len(trailing))
            spec = lead + tuple(trailing)
            # drop the axes that do not divide their dim evenly
            return P(*(None if ax is None or dim % _axes_size(am, ax)
                       else ax for dim, ax in zip(shape, spec)))
    return P()  # replicate (norm scales, biases, small vectors)


def param_shardings(mesh, params_shapes):
    """params_shapes: a tree of tensors (meta tensors from
    ``launch.steps.abstract_params`` will do)."""
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for(path, leaf.shape,
                                                        mesh)),
        params_shapes)


def opt_state_shardings(mesh, opt_shapes):
    """Moments share the param rules (paths are nested under m/ and v/)."""
    def fn(path, leaf):
        if path == "step":
            return NamedSharding(mesh, P())
        clean = re.sub(r"^(m|v)/", "", path)
        return NamedSharding(mesh, spec_for(clean, leaf.shape, mesh))
    return map_with_path(fn, opt_shapes)


def _dp_spec(mesh):
    am = as_abstract(mesh)
    dp = dp_axes(am)
    return math.prod(am.shape[a] for a in dp), \
        (dp if len(dp) > 1 else dp[0])


def batch_shardings(mesh, batch_shapes):
    """Inputs: shard the batch dim over dp when divisible, else replicate
    (``mrope_positions`` (3, B, S): its dim 1)."""
    dpsize, dp_spec = _dp_spec(mesh)

    def fn(path, leaf):
        shape = leaf.shape
        if not shape:
            return NamedSharding(mesh, P())
        if "mrope" in path:  # (3, B, S)
            if shape[1] % dpsize == 0:
                return NamedSharding(mesh, P(None, dp_spec))
            return NamedSharding(mesh, P())
        if shape[0] % dpsize == 0:
            return NamedSharding(mesh, P(dp_spec))
        return NamedSharding(mesh, P())
    return map_with_path(fn, batch_shapes)


def cache_shardings(mesh, cache_shapes):
    """Decode caches: KV (B, KV, S, dh) -> batch over dp if divisible, S
    over model (a sequence-sharded cache). SSM states shard batch only,
    located from the right. ``positions`` (..., B, length): batch over
    dp."""
    am = as_abstract(mesh)
    dpsize, dp_spec = _dp_spec(am)

    def fn(path, leaf):
        shape = leaf.shape
        if not shape:
            return NamedSharding(mesh, P())
        if path.endswith("positions"):
            if len(shape) >= 2 and shape[-2] % dpsize == 0:
                return NamedSharding(mesh, P(
                    *(None,) * (len(shape) - 2), dp_spec, None))
            return NamedSharding(mesh, P())
        b_ok = shape[-4] % dpsize == 0 if len(shape) >= 4 else False
        if re.search(r"(kv/k|kv/v|cross_k|cross_v)$", path) \
                and len(shape) >= 4:
            seq_ok = shape[-2] % am.shape["model"] == 0
            lead = (None,) * (len(shape) - 4)
            return NamedSharding(mesh, P(
                *lead, dp_spec if b_ok else None, None,
                "model" if seq_ok else None, None))
        # ssm state (..., B, H, P, N) and conv window (..., B, k-1, C)
        if path.endswith("ssm"):
            bidx = len(shape) - 4
        elif path.endswith("conv"):
            bidx = len(shape) - 3
        else:
            return NamedSharding(mesh, P())
        if bidx >= 0 and shape[bidx] % dpsize == 0:
            spec = [None] * len(shape)
            spec[bidx] = dp_spec
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())
    return map_with_path(fn, cache_shapes)
