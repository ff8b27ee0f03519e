"""Where a serving fleet's replicas run (port of ``serving_mesh`` and
``replica_devices`` in ``repro.sharding.rules``).

Inference replicas are pure data parallelism: whole-model copies, batches
split across them. So a fleet needs only the 1-D ``data`` axis over the
host's devices; here that axis is the list of CUDA devices
``torch.cuda.device_count()`` reports. The reference's FSDP x TP rule
table is the training story and is not ported.
"""
from __future__ import annotations

import torch


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
