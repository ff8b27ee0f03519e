"""The mesh context (port of ``repro.sharding.compat``).

Everything that asks "which mesh is active?" goes through this module, so
model code runs unchanged with or without one:

  * ``set_mesh(mesh)``      — context manager activating ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` or an ``AbstractMesh``)
    for this thread.
  * ``get_abstract_mesh()`` — the innermost active mesh as an
    ``AbstractMesh``: ``.empty``, ``.axis_names`` and ``.shape`` (a
    name -> size dict), plus ``.device_mesh`` where it has devices. With
    no mesh active, an empty one (never None).
  * ``abstract_mesh(axis_sizes, axis_names)`` — a mesh without devices,
    for rule-level use (``rules.spec_for`` and the shardings read only
    names and sizes).
"""
from __future__ import annotations

import contextlib
import threading


class AbstractMesh:
    """A mesh's axis names and sizes, and its ``DeviceMesh`` if it has one
    (``device_mesh``; None for a mesh without devices)."""

    def __init__(self, axis_sizes, axis_names, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"sizes {self.axis_sizes}")
        self.shape = dict(zip(self.axis_names, self.axis_sizes))
        self.device_mesh = device_mesh

    @property
    def empty(self) -> bool:
        return not self.axis_names

    def __repr__(self):
        sizes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        kind = "devices" if self.device_mesh is not None else "abstract"
        return f"AbstractMesh({sizes}; {kind})"


_EMPTY = AbstractMesh((), ())
_state = threading.local()


def as_abstract(mesh) -> AbstractMesh:
    """``mesh`` as an ``AbstractMesh``: itself, a ``DeviceMesh`` (its
    ``mesh_dim_names`` and sizes, keeping the mesh), or any object with
    ``.axis_names`` and a name -> size ``.shape``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return AbstractMesh(tuple(mesh.shape), names, device_mesh=mesh)
    shape = dict(mesh.shape)
    return AbstractMesh([shape[a] for a in mesh.axis_names], mesh.axis_names)


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def set_mesh(mesh):
    """Activate ``mesh`` for this thread until the block ends."""
    stack = _stack()
    stack.append(as_abstract(mesh))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def get_abstract_mesh() -> AbstractMesh:
    """The mesh installed by the innermost ``set_mesh`` (never None)."""
    stack = _stack()
    return stack[-1] if stack else _EMPTY


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    """A mesh of these sizes and names without devices."""
    return AbstractMesh(axis_sizes, axis_names)
