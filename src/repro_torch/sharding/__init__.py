"""Sharding: path-based parameter rules + activation hints (port of
``repro.sharding``).

The public surface, in three layers:

* ``rules`` — path -> PartitionSpec tables for parameters, optimizer
  state, batches and caches (FSDP x TP storage layout), their
  ``torch.distributed.tensor`` placements (``NamedSharding``, ``place``),
  plus the serving fleet's data-parallel axis: ``serving_mesh()`` /
  ``replica_devices()`` assign whole-model replicas to devices
  (``repro_torch.serve.fleet`` consumes these).
* ``hints`` — ``shard_hint`` activation layout pins that return their
  input unchanged without an active mesh or on a plain tensor, so model
  code runs as it is on one device.
* ``compat`` — the mesh context (``set_mesh``, ``get_abstract_mesh``,
  ``abstract_mesh``) everything mesh-touching goes through.
"""
from . import compat, hints, rules
from .compat import abstract_mesh, get_abstract_mesh, set_mesh
from .hints import shard_hint
from .rules import (batch_shardings, cache_shardings, dp_axes,
                    opt_state_shardings, param_shardings, replica_devices,
                    serving_mesh, spec_for)

__all__ = [
    # submodules
    "rules", "hints", "compat",
    # rule tables + fleet placement
    "dp_axes", "spec_for", "param_shardings", "opt_state_shardings",
    "batch_shardings", "cache_shardings", "serving_mesh", "replica_devices",
    # activation hints
    "shard_hint",
    # the mesh context
    "set_mesh", "get_abstract_mesh", "abstract_mesh",
]
