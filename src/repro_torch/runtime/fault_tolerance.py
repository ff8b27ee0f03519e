"""Fault tolerance for long multi-node runs: heartbeats, straggler
detection, a restart policy, a loss guard and the restart supervisor (the
port's own copy of ``repro.runtime.fault_tolerance``, pure Python).

A collective runtime fails stop-the-world on a node loss (a collective
times out and every process raises). The recovery loop is therefore
structural, not per-op:

    monitor -> detect (dead node / straggler / NaN) -> decide
            -> restore last committed checkpoint -> resume (maybe elastic)

Everything here is control plane and runs identically on the CPU; the
tests inject synthetic failures. `TrainSupervisor.run` is the generic
retry harness `launch/train.py` uses.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-node liveness. On real clusters nodes POST heartbeats to a
    coordinator; here `beat()` is called directly (tests inject silence)."""

    n_nodes: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_beat = {i: now for i in range(self.n_nodes)}

    def beat(self, node: int, t: float | None = None):
        self.last_beat[node] = self.clock() if t is None else t

    def dead_nodes(self) -> list[int]:
        now = self.clock()
        return [n for n, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_nodes()


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerDetector:
    """EWMA + z-score over per-node step times.

    A node is a straggler when its step time deviates from the fleet median
    by more than `z_thresh` fleet-MAD units for `patience` consecutive steps.
    Mitigation at scale: exclude the node and reshard (elastic), or swap in a
    hot spare; the decision callback gets the node list.
    """

    n_nodes: int
    alpha: float = 0.2            # EWMA smoothing
    z_thresh: float = 4.0
    patience: int = 3

    def __post_init__(self):
        self.ewma = [None] * self.n_nodes
        self.strikes = [0] * self.n_nodes

    def update(self, step_times: list[float]) -> list[int]:
        """Feed one step's per-node durations; returns current stragglers."""
        assert len(step_times) == self.n_nodes
        for i, t in enumerate(step_times):
            self.ewma[i] = t if self.ewma[i] is None else \
                self.alpha * t + (1 - self.alpha) * self.ewma[i]
        vals = sorted(self.ewma)
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        # floor at 5% of the median: a perfectly uniform fleet (MAD 0) must
        # not flag nodes for noise, and recovered nodes must un-flag as
        # their EWMA decays back toward the median
        scale = max(mad, 0.05 * max(med, 1e-9))
        out = []
        for i, v in enumerate(self.ewma):
            z = (v - med) / scale
            if z > self.z_thresh:
                self.strikes[i] += 1
            else:
                self.strikes[i] = 0
            if self.strikes[i] >= self.patience:
                out.append(i)
        return out


# ---------------------------------------------------------------------------
# restart policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RestartPolicy:
    """Exponential backoff with a failure budget (rolling window)."""

    max_restarts: int = 10
    window_s: float = 3600.0
    backoff_s: float = 5.0
    backoff_mult: float = 2.0
    max_backoff_s: float = 300.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.failures: list[float] = []

    def record_failure(self) -> bool:
        """Record one failure; returns True if a restart is allowed."""
        now = self.clock()
        self.failures = [t for t in self.failures if now - t < self.window_s]
        self.failures.append(now)
        return len(self.failures) <= self.max_restarts

    def next_delay(self) -> float:
        n = len(self.failures)
        return min(self.backoff_s * self.backoff_mult ** max(0, n - 1),
                   self.max_backoff_s)


# ---------------------------------------------------------------------------
# NaN / loss-spike guard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossGuard:
    """Detects divergence: NaN/inf loss, or loss > spike_mult x running min.
    On trigger the supervisor restores the last checkpoint and (optionally)
    skips the bad data window."""

    spike_mult: float = 10.0
    warmup: int = 20

    def __post_init__(self):
        self.best = math.inf
        self.n = 0

    def check(self, loss: float) -> bool:
        """True => healthy; False => diverged."""
        self.n += 1
        if math.isnan(loss) or math.isinf(loss):
            return False
        if self.n > self.warmup and loss > self.spike_mult * max(self.best, 1e-9):
            return False
        self.best = min(self.best, loss)
        return True


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class NodeFailure(RuntimeError):
    """Raised by the step function when the collective runtime dies
    (in tests: injected)."""


@dataclasses.dataclass
class TrainSupervisor:
    """Generic restart harness:

        sup = TrainSupervisor(policy, make_state, run_segment)
        sup.run()

    `make_state(restore_step)` builds/(re)loads training state;
    `run_segment(state)` advances until failure (raising NodeFailure) or
    completion (returning None) or a checkpoint boundary (returning state').
    The harness owns backoff, the failure budget, and the restart loop; it
    is deliberately ignorant of torch so the tests can drive it with fakes.
    """

    policy: RestartPolicy
    make_state: Callable
    run_segment: Callable
    sleep: Callable[[float], None] = time.sleep

    def run(self):
        state = self.make_state(None)
        restarts = 0
        while True:
            try:
                state = self.run_segment(state)
                if state is None:
                    return {"restarts": restarts, "completed": True}
            except NodeFailure:
                if not self.policy.record_failure():
                    return {"restarts": restarts, "completed": False,
                            "reason": "failure budget exhausted"}
                self.sleep(self.policy.next_delay())
                restarts += 1
                state = self.make_state("latest")
