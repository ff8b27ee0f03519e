"""Continuous-batching policy: wait-vs-dispatch and admission control as a
pure, separately-testable object.

The async runtime (``repro_torch.serve.runtime``) owns threads, queues and
futures; every *decision* lives here, in methods that take the observable
state (backlog, oldest submit time, the current clock reading) as explicit
arguments and return a ``Decision`` value. Nothing in this module reads a
wall clock or sleeps, so a test can replay any schedule deterministically
and pin the full decision table.

The policy triangle:

* **Batching window** — a lone request is not dispatched the instant it
  arrives; waiting up to ``max_wait_ms`` lets later arrivals fill the
  bucket and amortize the step. The dispatch shape is the FIRST chunk of
  the pad-minimizing split the compiled model itself would run
  (``repro_torch.infer.compile.plan_chunks`` — the same function, not a
  copy),
  so a backlog of 3 over buckets (2, 8) dispatches 2 now and leaves 1 to
  keep accumulating.
* **SLO pressure** — with ``slo_ms`` set, the window closes early: the
  oldest request must leave enough of its budget to actually run the step,
  estimated from an EWMA of observed per-bucket step times
  (``observe_step``). A scheduler that batches greedily but blows the
  latency target has optimized the wrong number.
* **Admission control** — ``admit()`` bounds the queue at
  ``max_queue_images``; overload is an explicit, accounted rejection
  (``QueueFull`` at the submit door), never silent unbounded growth.
"""
from __future__ import annotations

import dataclasses

from ..infer.compile import plan_chunks


class QueueFull(RuntimeError):
    """Admission control rejected a submit: the bounded queue is full.

    Raised at the submit door — the caller sheds or retries; the runtime
    never buffers beyond the configured depth.
    """


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """The scheduler's knobs, all decided before serving starts.

    ``max_wait_ms`` — batching window: how long the oldest queued request
    may wait for companions before a (possibly padded) dispatch is forced.
    ``slo_ms`` — per-request latency target; ``None`` disables SLO pressure
    (the window is then bounded by ``max_wait_ms`` alone).
    ``max_queue_images`` — admission bound on queued images.
    ``sparse_occupancy`` — spike-occupancy threshold splitting observed
    step times into a "sparse" and a "dense" EWMA per bucket (a sparse
    batch through the zero-chunk-skipping route is measurably cheaper, and
    folding both populations into one EWMA makes the SLO deadline wrong
    for whichever class is current); ``None`` disables the split.
    """
    max_wait_ms: float = 25.0
    slo_ms: float | None = None
    max_queue_images: int = 512
    sparse_occupancy: float | None = 0.35

    def __post_init__(self):
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got "
                             f"{self.max_wait_ms!r}")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0 (or None), got "
                             f"{self.slo_ms!r}")
        if self.max_queue_images < 1:
            raise ValueError(f"max_queue_images must be >= 1, got "
                             f"{self.max_queue_images!r}")
        if (self.sparse_occupancy is not None
                and not 0.0 < self.sparse_occupancy <= 1.0):
            raise ValueError(f"sparse_occupancy must be in (0, 1] (or "
                             f"None), got {self.sparse_occupancy!r}")

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_ms / 1e3

    @property
    def slo_s(self) -> float | None:
        return None if self.slo_ms is None else self.slo_ms / 1e3


@dataclasses.dataclass(frozen=True)
class Decision:
    """One scheduling decision, as a value.

    ``action`` is "idle" (nothing queued — sleep until a submit),
    "wait" (keep the batching window open for ``wait_s`` more seconds),
    or "dispatch" (run ``rows`` real rows in a ``bucket``-shaped step now).
    ``reason`` names the rule that fired — it surfaces in logs and pins the
    decision table in tests.

    ``replica`` is the placement extension (``FleetScheduler``): which
    replica runs a dispatched chunk. ``None`` means "the caller's only
    worker" — the single-runtime decisions are unchanged values.
    """
    action: str
    bucket: int = 0
    rows: int = 0
    wait_s: float = 0.0
    reason: str = ""
    replica: int | None = None


class ContinuousBatchingScheduler:
    """Wait-vs-dispatch policy over a compiled model's bucket set.

    Construct from the bucket tuple (``model.buckets``) and a
    ``ServePolicy``. All methods are deterministic functions of their
    arguments and the observed step-time EWMAs — no hidden clock.
    """

    def __init__(self, buckets, policy: ServePolicy | None = None):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets!r}")
        self.policy = policy or ServePolicy()
        self._step_s: dict[int, float] = {}   # bucket -> EWMA step seconds
        # (bucket, "sparse"|"dense") -> EWMA step seconds, fed only when
        # the runtime measures batch occupancy; the overall per-bucket
        # EWMA above always updates, so the class split can only refine
        self._class_step_s: dict[tuple, float] = {}
        self._occ_ewma: float | None = None   # EWMA of observed occupancy

    # -- admission ----------------------------------------------------------

    def admit(self, queued_images: int, new_images: int) -> bool:
        """May a request of ``new_images`` enter a queue currently holding
        ``queued_images``? Pure bound check; the runtime turns False into
        an explicit ``QueueFull`` at the submit door."""
        return queued_images + new_images <= self.policy.max_queue_images

    # -- service-time model -------------------------------------------------

    def _occupancy_class(self, occupancy: float) -> str | None:
        """"sparse" or "dense" under the policy threshold, ``None`` when
        the split is disabled."""
        thr = self.policy.sparse_occupancy
        if thr is None:
            return None
        return "sparse" if occupancy < thr else "dense"

    def observe_step(self, bucket: int, seconds: float,
                     occupancy: float | None = None) -> None:
        """Feed one measured step time into the per-bucket EWMA the SLO
        deadline uses. The runtime calls this after every step; when it
        also measured the batch's spike occupancy, the sample additionally
        updates the (bucket, sparse|dense) class EWMA so the deadline can
        condition on how cheap the current traffic actually is."""
        prev = self._step_s.get(bucket)
        self._step_s[bucket] = (seconds if prev is None
                                else 0.8 * prev + 0.2 * seconds)
        if occupancy is None:
            return
        self._occ_ewma = (occupancy if self._occ_ewma is None
                          else 0.8 * self._occ_ewma + 0.2 * occupancy)
        cls = self._occupancy_class(occupancy)
        if cls is not None:
            key = (bucket, cls)
            prev = self._class_step_s.get(key)
            self._class_step_s[key] = (seconds if prev is None
                                       else 0.8 * prev + 0.2 * seconds)

    def service_estimate(self, bucket: int,
                         occupancy: float | None = None) -> float:
        """Expected step seconds for ``bucket``: the (bucket, class) EWMA
        when an occupancy is given (or the running occupancy EWMA stands
        in) and that class has been observed; else the bucket's overall
        EWMA; else the slowest observed bucket (conservative —
        over-estimating dispatches earlier, never later); else 0 (no data:
        only ``max_wait_ms`` bounds the window)."""
        occ = occupancy if occupancy is not None else self._occ_ewma
        if occ is not None:
            cls = self._occupancy_class(occ)
            if cls is not None and (bucket, cls) in self._class_step_s:
                return self._class_step_s[(bucket, cls)]
        if bucket in self._step_s:
            return self._step_s[bucket]
        if self._step_s:
            return max(self._step_s.values())
        return 0.0

    def service_snapshot(self) -> dict:
        """The observed per-bucket step-second EWMAs, ``{bucket: seconds}``
        — the service-time model a deterministic decision replay
        (``repro_torch.serve.loadgen.replay_decisions``) can feed back in, so a
        simulated table uses the service times a live run actually
        measured. A copy: mutating it never touches the live policy."""
        return dict(self._step_s)

    def debug_state(self) -> dict:
        """EVERY table behind the wait-vs-dispatch decision, as plain data
        — the inspectability hook for "why did the window close here?".
        Keys mirror the internal tables: ``step_s`` is ``{bucket: EWMA
        seconds}``, ``class_step_s`` is ``{"<bucket>/<sparse|dense>":
        EWMA seconds}`` (string keys: this dict feeds JSON debug
        endpoints and gauge names), ``occupancy_ewma`` the running
        occupancy estimate (``None`` before any measured step). A copy —
        mutating it never touches the live policy."""
        return {
            "buckets": list(self.buckets),
            "step_s": dict(self._step_s),
            "class_step_s": {f"{b}/{cls}": v for (b, cls), v
                             in self._class_step_s.items()},
            "occupancy_ewma": self._occ_ewma,
        }

    def publish(self, registry, *, prefix: str = "scheduler/") -> None:
        """Publish ``debug_state()`` into a ``repro_torch.obs.MetricsRegistry``
        as gauges (``scheduler/step_s/<bucket>``, ``scheduler/
        class_step_s/<bucket>/<class>``, ...). Generic over the snapshot
        shape, so ``FleetScheduler``'s extra replica tables publish
        through this same method."""
        for section, table in self.debug_state().items():
            if section == "buckets":
                continue
            if isinstance(table, dict):
                for key, v in table.items():
                    registry.gauge(f"{prefix}{section}/{key}").set(float(v))
            elif table is not None:
                registry.gauge(f"{prefix}{section}").set(float(table))

    # -- the decision -------------------------------------------------------

    def decide(self, *, backlog: int, oldest_submit_s: float | None,
               now_s: float, draining: bool = False) -> Decision:
        """The wait-vs-dispatch decision for the current queue state.

        ``backlog`` is queued images, ``oldest_submit_s`` the submit
        timestamp of the request at the head of the queue (same clock as
        ``now_s``). ``draining=True`` (runtime shutdown) closes the
        batching window: anything queued dispatches immediately in its
        pad-minimizing shape.
        """
        if backlog <= 0:
            return Decision(action="idle", reason="queue empty")
        bmax = self.buckets[-1]
        if backlog >= bmax:
            # a full largest bucket never waits: zero pad, max amortization
            return Decision(action="dispatch", bucket=bmax, rows=bmax,
                            reason="backlog fills the largest bucket")
        rows, bucket = plan_chunks(backlog, self.buckets)[0]
        if draining:
            return Decision(action="dispatch", bucket=bucket, rows=rows,
                            reason="draining")
        if oldest_submit_s is None:
            raise ValueError("non-empty backlog requires oldest_submit_s")
        deadline = oldest_submit_s + self.policy.max_wait_s
        reason = "max_wait deadline reached"
        if self.policy.slo_s is not None:
            # Leave the oldest request enough budget to actually run — over
            # the WHOLE pad-minimizing split, not just the first chunk: the
            # oldest request's last image may land in the final chunk of a
            # multi-chunk backlog, so its completion pays every step in the
            # split, and reserving one step's worth under-budgets the rest.
            est = sum(self.service_estimate(b)
                      for _, b in plan_chunks(backlog, self.buckets))
            slo_deadline = oldest_submit_s + self.policy.slo_s - est
            if slo_deadline < deadline:
                deadline, reason = slo_deadline, "SLO pressure"
        if now_s >= deadline:
            return Decision(action="dispatch", bucket=bucket, rows=rows,
                            reason=reason)
        return Decision(action="wait", wait_s=deadline - now_s,
                        reason=f"batching window open ({reason.split()[0]} "
                               f"deadline in {deadline - now_s:.4f}s)")


class FleetScheduler(ContinuousBatchingScheduler):
    """Wait-vs-dispatch PLUS placement over ``n_replicas`` workers.

    Same pure contract as the base scheduler — every method is a
    deterministic function of its arguments and the observed EWMAs, so a
    fleet's full decision table (including which replica got which bucket
    chunk) replays under an injected clock. Placement policy:

    * each replica keeps its OWN per-bucket and per-(bucket, sparse|dense)
      step-time EWMAs, fed by ``observe_step(..., replica=i)`` — replicas
      on different devices (or a replica mid-degradation) have genuinely
      different service times, and one global estimate would route batches
      to whichever replica happened to be measured last;
    * ``place()`` sends a chunk to the FREE replica whose class-conditioned
      estimate for that bucket is lowest (ties break on the lowest index,
      keeping the table deterministic) — under sparse/dense SLO pressure
      that is the replica whose estimate meets the deadline;
    * when every replica is busy, ``decide()`` returns a bounded "wait"
      instead of a dispatch nobody can run; a completion re-opens the
      decision (the fleet's condition variable wakes the dispatcher).
    """

    def __init__(self, buckets, policy: ServePolicy | None = None, *,
                 n_replicas: int = 1):
        super().__init__(buckets, policy)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas!r}")
        self.n_replicas = int(n_replicas)
        self._replica_step_s: dict[tuple, float] = {}   # (replica, bucket)
        # (replica, bucket, "sparse"|"dense") -> EWMA step seconds
        self._replica_class_step_s: dict[tuple, float] = {}

    def observe_step(self, bucket: int, seconds: float,
                     occupancy: float | None = None,
                     replica: int | None = None) -> None:
        """Feed one measured step: the global EWMAs (SLO pressure budgets
        the whole split regardless of where chunks ran) AND, when
        ``replica`` is named, that replica's own estimates."""
        super().observe_step(bucket, seconds, occupancy=occupancy)
        if replica is None:
            return
        key = (replica, bucket)
        prev = self._replica_step_s.get(key)
        self._replica_step_s[key] = (seconds if prev is None
                                     else 0.8 * prev + 0.2 * seconds)
        if occupancy is None:
            return
        cls = self._occupancy_class(occupancy)
        if cls is not None:
            ckey = (replica, bucket, cls)
            prev = self._replica_class_step_s.get(ckey)
            self._replica_class_step_s[ckey] = (
                seconds if prev is None else 0.8 * prev + 0.2 * seconds)

    def debug_state(self) -> dict:
        """The base tables plus the per-replica EWMAs placement reads:
        ``replica_step_s`` is ``{"<replica>/<bucket>": seconds}``,
        ``replica_class_step_s`` ``{"<replica>/<bucket>/<class>":
        seconds}``."""
        return {
            **super().debug_state(),
            "n_replicas": self.n_replicas,
            "replica_step_s": {f"{r}/{b}": v for (r, b), v
                               in self._replica_step_s.items()},
            "replica_class_step_s": {
                f"{r}/{b}/{cls}": v for (r, b, cls), v
                in self._replica_class_step_s.items()},
        }

    def replica_estimate(self, replica: int, bucket: int,
                         occupancy: float | None = None) -> float:
        """Expected step seconds for ``bucket`` ON ``replica``: the
        replica's (bucket, class) EWMA when an occupancy (or the running
        occupancy EWMA) selects an observed class, else the replica's
        bucket EWMA, else the fleet-wide ``service_estimate`` (a fresh or
        freshly-swapped replica borrows the fleet's estimate until it has
        history of its own)."""
        occ = occupancy if occupancy is not None else self._occ_ewma
        if occ is not None:
            cls = self._occupancy_class(occ)
            if cls is not None and (replica, bucket, cls) in \
                    self._replica_class_step_s:
                return self._replica_class_step_s[(replica, bucket, cls)]
        if (replica, bucket) in self._replica_step_s:
            return self._replica_step_s[(replica, bucket)]
        return self.service_estimate(bucket, occupancy)

    def place(self, bucket: int, *, busy, occupancy: float | None = None) \
            -> int | None:
        """The free replica with the lowest class-conditioned estimate for
        ``bucket`` (lowest index on ties); ``None`` when ``busy`` masks
        every replica."""
        free = [i for i in range(self.n_replicas) if not busy[i]]
        if not free:
            return None
        return min(free, key=lambda i: (self.replica_estimate(i, bucket,
                                                              occupancy), i))

    def decide(self, *, backlog: int, oldest_submit_s: float | None,
               now_s: float, draining: bool = False, busy=None) -> Decision:
        """The base wait-vs-dispatch decision, with a dispatch placed onto
        a replica. ``busy`` is the per-replica busy mask (default: all
        free). A dispatch with nowhere to run becomes a bounded wait —
        never a silent queue on a busy replica the policy did not pick."""
        d = super().decide(backlog=backlog, oldest_submit_s=oldest_submit_s,
                           now_s=now_s, draining=draining)
        if d.action != "dispatch":
            return d
        busy = (False,) * self.n_replicas if busy is None else tuple(busy)
        if len(busy) != self.n_replicas:
            raise ValueError(f"busy mask has {len(busy)} entries for "
                             f"{self.n_replicas} replicas")
        r = self.place(d.bucket, busy=busy)
        if r is None:
            return Decision(action="wait",
                            wait_s=max(self.policy.max_wait_s, 1e-3),
                            reason="all replicas busy")
        return dataclasses.replace(d, replica=r)
