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
* ``takes_device``: whether the factory is handed the target device (the
  ``packed`` backend picks its branch by it).

A plan the JAX package wrote names one of its own backends;
``port_backend`` says which of the port's runs it.
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
    takes_device: bool = False

    def make(self, *, device=None, **options):
        """A backend instance from ``options`` (the reference's contract:
        a key the factory does not take raises ``TypeError``); a factory
        that ``takes_device`` also gets ``device`` (default: the card)."""
        if self.takes_device:
            options["device"] = torch.device(
                "cuda" if device is None else device)
        return self.factory(**options)


_REGISTRY: dict[str, BackendSpec] = {}
_ALIASES: dict[str, str] = {}


def register_backend(name: str, factory: Callable[..., Any], *,
                     weight_dtypes=("float32", "int8"),
                     device_kinds=("cuda", "cpu"),
                     wants_lut_tables: bool = True,
                     aliases=(), takes_device: bool = False) -> BackendSpec:
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
                       aliases=tuple(aliases), takes_device=takes_device)
    _REGISTRY[name] = spec
    for a in aliases:
        _ALIASES[a] = name
    return spec


def unregister_backend(name: str) -> None:
    """Remove a registration, by name or alias; removing via an alias drops
    the whole spec and its aliases."""
    spec = _REGISTRY.pop(_ALIASES.get(name, name), None)
    if spec is not None:
        for a in spec.aliases:
            _ALIASES.pop(a, None)


def list_backends(*, weight_dtype: str | None = None,
                  device_kind: str | None = None) -> list[str]:
    """Registered backend names, filtered by capability."""
    return [name for name, spec in sorted(_REGISTRY.items())
            if (weight_dtype is None or weight_dtype in spec.weight_dtypes)
            and (device_kind is None or device_kind in spec.device_kinds)]


def wants_lut_tables(name_or_instance, backend) -> bool:
    """Resolve the table capability: the spec's declaration for a name,
    else the instance's own ``wants_lut_tables`` attribute, else True."""
    if isinstance(name_or_instance, str):
        return backend_spec(name_or_instance).wants_lut_tables
    return bool(getattr(backend, "wants_lut_tables", True))


def port_backend(name: str, options: dict) -> tuple[str, dict]:
    """The port's backend and options for a plan's ``backend`` and
    ``backend_options``, mapping the reference's Pallas names:
    ``packed_pallas`` with ``{"interpret": True}`` (the reference's kernels
    run by the Pallas interpreter on the host) runs ``packed_plain`` (the
    kernels' plain versions), ``packed_pallas`` otherwise ``packed_cuda``
    (the kernels on the card). Other names, ``packed`` among them, pass
    through."""
    options = dict(options)
    if name == "packed_pallas":
        interpret = options.pop("interpret", False)
        return ("packed_plain" if interpret else "packed_cuda"), options
    return name, options


def backend_spec(name: str) -> BackendSpec:
    """Spec by name or alias; unknown names fail with the registered set."""
    spec = _REGISTRY.get(_ALIASES.get(name, name))
    if spec is None:
        raise ValueError(f"unknown inference backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return spec


def get_backend(name: str, *, device: torch.device, **options):
    """Backend instance for ``device``; fails when the backend is not built
    for that kind of device. ``options`` go to ``BackendSpec.make``."""
    spec = backend_spec(name)
    if device.type not in spec.device_kinds:
        raise ValueError(f"backend {spec.name!r} runs on "
                         f"{list(spec.device_kinds)}, not on {device.type!r}")
    return spec.make(device=device, **options)
