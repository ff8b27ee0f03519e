"""Backend registry (port of ``repro.infer.registry``): backends as
declared capabilities. ``compile()`` resolves ``ExecutionPlan.backend``
here, by name or alias, and checks the plan's weight dtype and the target
device against what the backend declares. A run on the CPU is asked for by
device: there is no flag that keeps a backend's name while it runs
something else.

Capabilities:

* ``weight_dtypes``: the ``ExecutionPlan.weight_dtype`` values the
  backend executes.
* ``device_kinds``: the torch device types it runs on ("cuda", "cpu");
  ``get_backend`` refuses any other.
* ``wants_lut_tables``: whether route planning builds the (C, 256, N)
  byte-LUT tables into the backend's tree, or only flags LUT-planned
  layers with True (the reference backend replays the fold from the flag).
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
    aliases: tuple[str, ...] = ()


_REGISTRY: dict[str, BackendSpec] = {}
_ALIASES: dict[str, str] = {}


def register_backend(name: str, factory: Callable[..., Any], *,
                     weight_dtypes=("float32", "int8"),
                     device_kinds=("cuda", "cpu"),
                     wants_lut_tables: bool = True,
                     aliases=()) -> BackendSpec:
    """Register ``factory(**options) -> backend`` under ``name`` and its
    ``aliases``; refuses to shadow a name or alias already taken."""
    taken = {name, *aliases} & ({*_REGISTRY} | {*_ALIASES})
    if taken:
        raise ValueError(f"backend name(s) {sorted(taken)} already "
                         "registered")
    spec = BackendSpec(name=name, factory=factory,
                       weight_dtypes=tuple(weight_dtypes),
                       device_kinds=tuple(device_kinds),
                       wants_lut_tables=wants_lut_tables,
                       aliases=tuple(aliases))
    _REGISTRY[name] = spec
    for a in aliases:
        _ALIASES[a] = name
    return spec


def backend_spec(name: str) -> BackendSpec:
    """Spec by name or alias; unknown names fail with the registered set."""
    spec = _REGISTRY.get(_ALIASES.get(name, name))
    if spec is None:
        raise ValueError(f"unknown inference backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return spec


def get_backend(name: str, *, device: torch.device, **options):
    """Backend instance for ``device``; fails when the backend is not built
    for that kind of device. ``options`` go to the factory, which raises
    ``TypeError`` on a key it does not take."""
    spec = backend_spec(name)
    if device.type not in spec.device_kinds:
        raise ValueError(f"backend {spec.name!r} runs on "
                         f"{list(spec.device_kinds)}, not on {device.type!r}")
    return spec.factory(**options)
