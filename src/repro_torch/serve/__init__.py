"""Asynchronous continuous-batching serving over a ``CompiledModel`` —
the open-loop half of the serving story. ``AsyncServeRuntime`` accepts
requests from caller threads into a bounded queue and completes futures as
the background worker's bucket steps finish; ``ServeFleet`` scales that
shape to N replicas behind one placement-aware ``FleetScheduler``; every
scheduling decision is pure and clock-injected; ``loadgen`` measures
goodput / tail latency / SLO attainment under a real arrival process.
All three serving surfaces (sync ``MicroBatchEngine``, async runtime,
fleet) speak the ``ServeClient`` protocol — submit / stats / close —
with one versioned stats schema."""
from ..infer.engine import SERVE_STATS_VERSION, ServeClient
from .fleet import ServeFleet
from .loadgen import (Arrival, burst_trace, burstiness, image_maker,
                      poisson_trace, replay_decisions, run_open_loop,
                      run_replica_sweep, validate_trace)
from .runtime import AsyncRequest, AsyncServeRuntime
from .scheduler import (ContinuousBatchingScheduler, Decision,
                        FleetScheduler, QueueFull, ServePolicy)

__all__ = [
    "ServeClient", "SERVE_STATS_VERSION",
    "AsyncRequest", "AsyncServeRuntime", "ServeFleet",
    "ContinuousBatchingScheduler", "FleetScheduler", "Decision",
    "QueueFull", "ServePolicy",
    "Arrival", "image_maker", "poisson_trace", "burst_trace", "burstiness",
    "replay_decisions", "run_open_loop", "run_replica_sweep",
    "validate_trace",
]
