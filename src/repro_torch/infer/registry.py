"""Backend registry (port of ``repro.infer.registry``): backends as
declared capabilities. ``compile()`` resolves ``ExecutionPlan.backend``
here and checks the plan's weight dtype and the target device against
what the backend declares. A run on the CPU is asked for by device: there
is no flag that keeps a backend's name while it runs something else.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered backend: how to build it and what it can do."""
    name: str
    factory: Callable[..., Any]
    weight_dtypes: tuple[str, ...] = ("float32", "int8")
    device_kinds: tuple[str, ...] = ("cuda", "cpu")
    wants_lut_tables: bool = True


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, factory: Callable[..., Any]) -> BackendSpec:
    """Register ``factory(**options) -> backend`` under ``name``; refuses
    to shadow an existing name."""
    if name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    spec = _REGISTRY[name] = BackendSpec(name=name, factory=factory)
    return spec


def backend_spec(name: str) -> BackendSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown inference backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return spec


def get_backend(name: str, *, device: torch.device, **options):
    """Backend instance for ``device``; fails when the backend is not built
    for that kind of device."""
    spec = backend_spec(name)
    if device.type not in spec.device_kinds:
        raise ValueError(f"backend {name!r} runs on {list(spec.device_kinds)}"
                         f", not on {device.type!r}")
    return spec.factory(**options)
