"""Meshes (port of ``repro.launch.mesh``). Functions, not module-level
constants, so importing this module starts no process group.

``make_production_mesh`` is the reference's 256-chip pod layout as an
``AbstractMesh``: no process group of 256 ranks exists here, so it is for
rule-level use (``sharding.rules``) only. ``make_cpu_mesh`` builds a real
``DeviceMesh`` with axes ``("data", "model")`` over the initialised
world.
"""
from __future__ import annotations

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
