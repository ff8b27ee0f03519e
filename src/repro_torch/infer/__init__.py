"""Packed-spike Spikformer inference: compile a model under an
``ExecutionPlan`` and serve it with ``MicroBatchEngine``."""
from .compile import CompiledModel, ExecutionPlan, compile, plan_chunks
from .engine import MicroBatchEngine, Request, serve_stats

__all__ = ["CompiledModel", "ExecutionPlan", "MicroBatchEngine", "Request",
           "compile", "plan_chunks", "serve_stats"]
