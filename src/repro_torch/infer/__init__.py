"""Packed-spike Spikformer inference behind a compile/serve split:
``compile(params, cfg, plan)`` lowers to a ``CompiledModel``,
``MicroBatchEngine`` serves it (and ``replicate_model`` makes the copies
the multi-replica fleet serves). Every serving surface implements the
``ServeClient`` protocol with the versioned ``serve_stats`` schema."""
from .backends import (OccupancyRecorder, PackedBackend, chunk_occupancy,
                       spike_occupancy, value_chunk_occupancy)
from .compile import (CompiledModel, ExecutionPlan,
                      calibrate_layer_occupancy, compile, plan_chunks,
                      replicate_model)
from .engine import (PAPER_FPS, SERVE_STATS_VERSION, MicroBatchEngine,
                     QueueDepthWatermark, Request, ServeClient,
                     batch_occupancy, serve_stats)
from .registry import (BackendSpec, backend_spec, list_backends,
                       register_backend, unregister_backend)

__all__ = [
    # compile half
    "ExecutionPlan", "CompiledModel", "compile", "plan_chunks",
    "replicate_model", "calibrate_layer_occupancy",
    # serve half
    "MicroBatchEngine", "Request", "PAPER_FPS", "batch_occupancy",
    "ServeClient", "serve_stats", "SERVE_STATS_VERSION",
    "QueueDepthWatermark",
    # backends, occupancy readouts and registry
    "PackedBackend", "OccupancyRecorder", "spike_occupancy",
    "chunk_occupancy", "value_chunk_occupancy", "BackendSpec", "register_backend", "unregister_backend",
    "backend_spec", "list_backends",
]
