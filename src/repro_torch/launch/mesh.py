"""Meshes (port of ``repro.launch.mesh``). Functions, not module-level
constants, so importing this module starts no process group.

``make_production_mesh`` is the reference's 256-chip pod layout as an
``AbstractMesh``, for rule-level use (``sharding.rules``). ``fake_world``
makes the same layout (``production_shape``), or any other, a real
``DeviceMesh`` over a fake world: torch's ``fake`` process-group backend
at 256 or 512 ranks, seen from rank 0, whose collectives move nothing
(the counterpart of the reference's 512 placeholder host devices;
``launch/dryrun.py`` traces steps on it over meta tensors).
``make_cpu_mesh`` builds a real ``DeviceMesh`` with axes ``("data",
"model")`` over the initialised world.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device
from ..sharding.compat import abstract_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; multi_pod adds a 2-pod leading axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def production_shape(*, multi_pod: bool = False) -> tuple:
    """``(shape, axis names)`` of the production mesh."""
    am = make_production_mesh(multi_pod=multi_pod)
    return am.axis_sizes, am.axis_names


def fake_device_type() -> str:
    """A fake world's mesh device type by default: ``cuda`` where torch
    sees a card, else ``cpu`` (DTensor's metadata propagation makes fake
    tensors of the mesh's device type, which a CPU build cannot run every
    op on). Either way the world's collectives are those of the H100
    deployment it models (``fake_world``)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def all_to_all_as_on_the_card():
    """DTensor's shard-to-shard redistribution run, for the block, as on
    an NCCL mesh: one ``_dtensor.shard_dim_alltoall`` op (an all-to-all
    of the shard's bytes). On a ``cpu`` mesh DTensor does it as gloo can,
    an all-gather of the whole dim and a chunk kept, which moves and holds
    a group's worth more. Swaps the function wherever a DTensor module
    holds it; raises if this torch has no such function or op, since a
    trace would then count gloo's collectives as the card's."""
    import sys
    import torch.distributed.tensor.placement_types  # noqa: F401 (caller)
    from torch.distributed.tensor import _collective_utils as cu
    real = getattr(cu, "shard_dim_alltoall", None)
    op = getattr(getattr(torch.ops, "_dtensor", None), "shard_dim_alltoall",
                 None)
    holders = [mod for name, mod in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor")
               and real is not None
               and getattr(mod, "shard_dim_alltoall", None) is real]
    if op is None or len(holders) < 2:
        raise RuntimeError(
            "this torch has no DTensor shard_dim_alltoall to run as an "
            "all-to-all: a cpu-typed fake world would count an all-gather")

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    for mod in holders:
        mod.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        for mod in holders:
            mod.shard_dim_alltoall = real


@contextlib.contextmanager
def fake_world(shape, axis_names, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` (``axis_names``) over a fake process
    group of ``prod(shape)`` ranks, seen from rank 0: ranks, groups and
    coordinates as in a real world of that size, collectives that only
    make outputs of the right shape (on meta tensors: nothing allocated).
    ``device_type`` (default ``fake_device_type()``) is the mesh's; meta
    shards stay meta on either. The collectives are NCCL's on either, as
    on the H100 deployment the world models: on a ``cpu`` mesh DTensor's
    all-to-all runs as the all-to-all op, not as gloo's all-gather
    (``all_to_all_as_on_the_card``).
    Opens the group for the block and destroys it after, since a group
    left up breaks the next ``make_cpu_mesh``; refuses to start while
    another group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; a fake world "
                           "needs its own")
    device_type = device_type or fake_device_type()
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        with (all_to_all_as_on_the_card() if device_type == "cpu"
              else contextlib.nullcontext()):
            yield init_device_mesh(device_type, tuple(shape),
                                   mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def _init_one_rank(device=None) -> None:
    """A process group of one rank on ``device``'s backend (``nccl`` on
    the card, ``gloo`` on the CPU), rendezvoused through an in-process
    ``HashStore``: no TCP port is opened. A no-op if a group exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    kw = {"backend": "gloo"}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        kw = {"backend": "nccl", "device_id": dev}
    dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                            **kw)


def make_cpu_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``(data, model)`` ``DeviceMesh`` with ``mesh_dim_names``
    ``("data", "model")`` over the initialised world, on ``device``'s
    type (default: the card). With no process group, first creates a
    one-rank group (a ``HashStore``, so no TCP port is opened);
    the caller destroys it (``torch.distributed.destroy_process_group``).
    The world must hold ``data * model`` ranks. (The reference's name:
    the tiny mesh its CPU tests run on.)"""
    dev = resolve_device(device)
    _init_one_rank(dev)
    if dist.get_world_size() != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
