"""``ServeFleet`` — N compiled replicas behind ONE continuous-batching
scheduler: the "millions of users" axis of the serving story.

The async runtime is one worker over one ``CompiledModel``; this module
scales that shape out. One bounded queue and one admission door (the same
``ServeClient`` submit contract), one pure placement-aware scheduler
(``FleetScheduler``), and N replicas — each a ``CompiledModel`` plus a
worker thread. Replica placement follows ``repro_torch.sharding.rules``: on a
multi-device host ``replica_devices`` assigns each replica its own device
along the 1-D data-parallel serving mesh and
``repro_torch.infer.compile.replicate_model`` places its weights there; on a
single-device host the assignment degrades to thread-backed replicas that
share the template's folded tree, each with a step of its own (a graphed
step's static buffers cannot serve two threads), each worker on a CUDA
stream of its own.

Replica lifecycle (the state machine ``health()`` reports)::

    created -> warming -> ready <-> draining -> stopped
                             \\______________/
                                 hot swap

* **warmup** — ``start()`` captures every bucket's graph on every replica
  before the first request (a replica that captures on live traffic blows
  its first SLO).
* **health probes** — ``probe()`` pushes a zeros step through each ready
  replica and reports per-replica liveness/latency without touching the
  request queue.
* **draining** — a draining replica takes no new chunks; its in-flight
  step completes normally. ``close()`` drains the whole fleet: every
  accepted request resolves, exactly like the single runtime.
* **plan hot-swap** — ``swap(new_model)`` rolls a new
  ``ExecutionPlan``/weights across the fleet one replica at a time: the
  candidate is replicated and warmed OFF-path, the replica drains, the
  model pointer flips, the replica returns to ready — accepted requests
  keep completing on the other replicas throughout, so a weight push
  never drops a promise.

Placement is pure policy: ``FleetScheduler.decide(..., busy=mask)``
extends ``Decision`` with a ``replica`` index, chosen from per-replica
sparse/dense step-time EWMAs — so the full fleet decision table replays
deterministically under an injected clock.

``pace_fps`` models each replica as a fixed-rate accelerator core (the
paper's deployment unit: one VESTA core sustains ~30 fps): a replica's
step holds the slot for at least ``bucket_rows / pace_fps`` seconds.
Compute still runs — labels are real — but service time is the modeled
core's, so fleet scaling curves measure scheduling and placement rather
than how many host cores a CI runner happens to have. Leave it ``None``
(the default) to serve at raw hardware speed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from ..infer.compile import CompiledModel, replicate_model
from ..infer.engine import (QueueDepthWatermark, Request, StepAccounting,
                            assemble_batch, batch_occupancy, serve_stats,
                            to_host, validate_images, worker_stream)
from ..obs.metrics import LatencyHistogram
from ..obs.trace import NULL_TRACER
from ..sharding.rules import replica_devices
from .runtime import AsyncRequest
from .scheduler import FleetScheduler, QueueFull, ServePolicy

# replica lifecycle states (health()/stats() vocabulary)
CREATED, WARMING, READY, DRAINING, STOPPED = (
    "created", "warming", "ready", "draining", "stopped")


def _replica_model(model, device):
    """A replica's copy of ``model``: a ``CompiledModel`` is replicated
    (shared weights, its own step) even on the template's device; a
    stand-in model that is not one (tests' failing steps) is shared."""
    if isinstance(model, CompiledModel):
        return replicate_model(model, device=device)
    return model


class _Replica:
    """One fleet member: a compiled model, a device, a worker, and its
    lifecycle state. All mutable fields are guarded by the fleet's
    condition variable."""

    def __init__(self, idx: int, model, device=None):
        self.idx = idx
        self.model = model
        self.device = device
        self.state = CREATED
        self.steps = 0
        self.failures = 0
        self.swaps = 0
        self.warmup_s: float | None = None
        self.last_step_s: float | None = None
        self.last_probe_s: float | None = None
        self.acct = StepAccounting()
        self._work = None          # (Decision, [(request, image idx), ...])
        self.thread: threading.Thread | None = None

    @property
    def busy(self) -> bool:
        return self.state != READY or self._work is not None


class ServeFleet:
    """N-replica continuous-batching serving — the ``ServeClient``
    protocol (submit / stats / close) over one shared queue and a
    placement-aware scheduler.

        fleet = ServeFleet(model, replicas=4,
                           policy=ServePolicy(slo_ms=100)).start()
        req = fleet.submit(images_u8)       # same door as the runtime
        labels = req.result(timeout=5)
        fleet.swap(new_model)               # roll a new plan, zero drops
        fleet.close()                       # drain: every promise kept

    Determinism contract: per-image math is row-independent and
    bucket-invariant, and every replica runs the same resolved plan
    (``replicate_model`` shares it verbatim), so an identical request
    trace produces bit-identical labels through 1 replica or N.
    """

    def __init__(self, model, *, replicas: int = 1,
                 policy: ServePolicy | None = None,
                 scheduler: FleetScheduler | None = None,
                 devices=None, pace_fps: float | None = None,
                 tracer=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas!r}")
        if scheduler is not None and policy is not None:
            raise ValueError("pass either policy or a prebuilt scheduler")
        if pace_fps is not None and pace_fps <= 0:
            raise ValueError(f"pace_fps must be > 0 (or None), got "
                             f"{pace_fps!r}")
        self.model = model          # the template (validation, shapes)
        self.pace_fps = pace_fps
        if scheduler is not None:
            if not hasattr(scheduler, "place"):
                raise ValueError(
                    "fleet scheduler must speak placement (FleetScheduler: "
                    "decide(busy=...) -> Decision.replica)")
            if scheduler.n_replicas != replicas:
                raise ValueError(
                    f"scheduler plans {scheduler.n_replicas} replicas but "
                    f"the fleet has {replicas}")
            self.scheduler = scheduler
        else:
            self.scheduler = FleetScheduler(model.buckets, policy,
                                            n_replicas=replicas)
        if devices is None:
            on_card = getattr(getattr(model, "device", None), "type",
                              None) == "cuda"
            devices = (replica_devices(replicas) if on_card
                       else [None] * replicas)
        if len(devices) != replicas:
            raise ValueError(f"{len(devices)} devices for {replicas} "
                             f"replicas")
        self.replicas = [
            _Replica(i, _replica_model(model, dev), device=dev)
            for i, dev in enumerate(devices)]
        # CPU replicas take turns: a CPU step is thousands of short torch
        # ops, each of which releases and retakes the GIL, so two replica
        # threads stepping at once hand the GIL back and forth at every op
        # and each step takes 3-4x as long as alone. While one steps, the
        # dispatcher sees every replica busy and keeps the queue, so the
        # next batch is formed when a step can start. Paced replicas
        # (fixed-rate cores, mostly asleep in their slot) run side by side.
        self._take_turns = (replicas > 1 and pace_fps is None and getattr(
            getattr(model, "device", None), "type", None) == "cpu")
        self._clock = time.perf_counter
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._cv = threading.Condition()
        self._queue: deque = deque()        # (request, image index)
        self._pending: dict[int, int] = {}  # rid -> images left
        self._inflight: dict[int, AsyncRequest] = {}
        self._next_rid = 0
        self.done: list[AsyncRequest] = []
        self.rejected = 0
        self._queue_depth = QueueDepthWatermark()
        self.latency_hist = LatencyHistogram()
        self.acct = StepAccounting()
        self.failed_requests = 0
        self.swaps = 0
        self._closing = False
        self._stopping = False
        self._started = False
        self._error: BaseException | None = None
        self._dispatcher = threading.Thread(
            target=self._dispatch, daemon=True, name="repro-fleet-dispatch")

    @property
    def queue_depth_peak(self) -> int:
        return self._queue_depth.peak

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServeFleet":
        """Warm every replica (compile all buckets off-path), then start
        the dispatcher and replica workers. Idempotent; ``submit``
        auto-starts."""
        with self._cv:
            if self._started:
                return self
            self._started = True
            for rep in self.replicas:
                rep.state = WARMING
        for rep in self.replicas:
            if hasattr(rep.model, "warmup"):
                rep.warmup_s = rep.model.warmup()
        with self._cv:
            for rep in self.replicas:
                rep.state = READY
                rep.thread = threading.Thread(
                    target=self._replica_worker, args=(rep,), daemon=True,
                    name=f"repro-fleet-replica-{rep.idx}")
                rep.thread.start()
            self._dispatcher.start()
            self._cv.notify_all()
        return self

    def close(self, timeout: float | None = None) -> None:
        """Drain the fleet and stop every worker. Every accepted request
        resolves before the last thread exits; new submits are refused the
        moment closing begins. A ``drain_replica``'d replica rejoins the
        pool here — the final drain must be able to dispatch even if the
        caller had drained every replica."""
        with self._cv:
            self._closing = True
            for rep in self.replicas:
                if rep.state == DRAINING:
                    rep.state = READY
            started = self._started
            self._cv.notify_all()
        if not started:
            return
        self._dispatcher.join(timeout)
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout)

    def __enter__(self) -> "ServeFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submit door (identical contract to the runtime) --------------------

    def submit(self, images, *, rid: int | None = None,
               on_image=None) -> AsyncRequest:
        """Queue one request; returns immediately with an ``AsyncRequest``
        whose future resolves to the label list. Same door as
        ``AsyncServeRuntime.submit``: validation here, ``QueueFull`` on
        admission rejection, rid conflicts fail loudly."""
        t_enter = self._clock()
        arr = validate_images(images, self.model.input_shape()[1:])
        tr = self.tracer
        with self._cv:
            if self._error is not None:
                raise RuntimeError(f"fleet died: {self._error!r}")
            if self._closing:
                raise RuntimeError("fleet is closed")
            if rid is None:
                rid = self._next_rid
            if rid in self._pending:
                raise ValueError(f"request id {rid} is already in flight")
            if not self.scheduler.admit(len(self._queue), len(arr)):
                self.rejected += 1
                raise QueueFull(
                    f"queue holds {len(self._queue)} images; admitting "
                    f"{len(arr)} more would exceed max_queue_images="
                    f"{self.scheduler.policy.max_queue_images}")
            self._next_rid = max(self._next_rid, rid + 1)
            req = AsyncRequest(rid=rid, images=arr, on_image=on_image)
            req.t_submit = self._clock()
            req.labels = [None] * len(arr)
            if not len(arr):
                req.t_done = req.t_submit
                self.done.append(req)
                self.latency_hist.observe(0.0)
                if tr.enabled:
                    tr.span("request", "admit", t0=t_enter, t1=req.t_submit,
                            rid=req.rid, value=0)
                    tr.span("request", "complete", t0=req.t_submit,
                            t1=req.t_done, rid=req.rid)
                req.future.set_result([])
                return req
            self._pending[rid] = len(arr)
            self._inflight[rid] = req
            for i in range(len(arr)):
                self._queue.append((req, i))
            self._queue_depth.observe(len(self._queue))
            if tr.enabled:
                tr.span("request", "admit", t0=t_enter, t1=req.t_submit,
                        rid=req.rid, value=len(arr))
                tr.counter("queue_depth", len(self._queue), t=req.t_submit)
            must_start = not self._started
            self._cv.notify_all()
        if must_start:
            self.start()
        return req

    # -- dispatcher ---------------------------------------------------------

    def _dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as exc:
            self._abort(exc)
            raise

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stopping or self._error is not None:
                        return
                    now = self._clock()
                    oldest = (self._queue[0][0].t_submit if self._queue
                              else None)
                    busy = tuple(r.busy for r in self.replicas)
                    if self._take_turns and any(
                            r._work is not None for r in self.replicas):
                        busy = (True,) * len(busy)
                    d = self.scheduler.decide(
                        backlog=len(self._queue), oldest_submit_s=oldest,
                        now_s=now, draining=self._closing, busy=busy)
                    if d.action == "dispatch":
                        break
                    if self._closing and d.action == "idle":
                        # queue drained; once in-flight steps land, stop
                        if all(r._work is None for r in self.replicas):
                            self._stopping = True
                            self._cv.notify_all()
                            return
                        self._cv.wait()       # a completion notifies
                        continue
                    # "idle": sleep until a submit; "wait": window deadline
                    # or all-replicas-busy — a completion notifies early
                    self._cv.wait(d.wait_s if d.action == "wait" else None)
                work = [self._queue.popleft()
                        for _ in range(min(d.rows, len(self._queue)))]
                rep = self.replicas[d.replica]
                rep._work = (d, work)
                tr = self.tracer
                if tr.enabled:
                    t_pop = self._clock()
                    tr.span("batch", "place", t0=now, t1=t_pop,
                            bucket=d.bucket, replica=d.replica,
                            value=len(work))
                    tr.counter("queue_depth", len(self._queue), t=t_pop)
                    for r, _ in work:
                        if not r.t_dequeue:    # first image leaves queue
                            r.t_dequeue = t_pop
                            tr.span("request", "queue", t0=r.t_submit,
                                    t1=t_pop, rid=r.rid, replica=d.replica)
                self._cv.notify_all()

    # -- replica workers ----------------------------------------------------

    def _replica_worker(self, rep: _Replica) -> None:
        try:
            with worker_stream(rep.model):
                self._replica_loop(rep)
        except BaseException as exc:
            self._abort(exc)
            raise

    def _replica_loop(self, rep: _Replica) -> None:
        pace = self.pace_fps
        while True:
            with self._cv:
                while rep._work is None and not self._stopping \
                        and self._error is None:
                    self._cv.wait()
                if rep._work is None:          # stopping / aborted
                    rep.state = STOPPED
                    self._cv.notify_all()
                    return
                d, work = rep._work
                model = rep.model
            # model step OUTSIDE the lock: other replicas keep running
            tr = self.tracer
            try:
                t_start = self._clock()
                batch, _ = assemble_batch(
                    [req.images[i] for req, i in work], d.bucket)
                occ = batch_occupancy(batch[:len(work)])  # real rows only
                t0 = self._clock()
                if tr.enabled:
                    tr.span("batch", "assemble", t0=t_start, t1=t0,
                            bucket=d.bucket, replica=rep.idx,
                            occupancy=occ, value=len(work))
                # the read-back waits for the device: busy_s is the step's
                # real time
                logits = to_host(model.step(batch))
                if pace is not None:
                    # emulated fixed-rate core: the slot is held for the
                    # modeled service time (pads cost too, as in hardware)
                    gap = d.bucket / pace - (self._clock() - t0)
                    if gap > 0:
                        time.sleep(gap)
                busy_s = self._clock() - t0
                if tr.enabled:
                    tr.span("batch", "step", t0=t0, t1=t0 + busy_s,
                            bucket=d.bucket, replica=rep.idx,
                            occupancy=occ, value=len(work))
                    tr.counter("occupancy", occ, t=t0, replica=rep.idx)
            except Exception as exc:
                self._fail_batch(rep, work, exc)
                continue
            labels = logits[:len(work)].argmax(axis=-1)
            now = self._clock()
            completed, live = [], []
            with self._cv:
                for (req, i), lab in zip(work, labels):
                    if self._inflight.get(req.rid) is not req:
                        # another replica's step failed this request while
                        # our chunk was in flight: its bookkeeping is purged
                        # and its future already failed — drop our result
                        continue
                    live.append((req, i, int(lab)))
                    req.labels[i] = int(lab)
                    self._pending[req.rid] -= 1
                    if self._pending[req.rid] == 0:
                        del self._pending[req.rid]
                        self._inflight.pop(req.rid, None)
                        req.t_done = now
                        # release the payload; labels/timing/count survive
                        req.images = np.empty((len(req.labels), 0, 0, 0),
                                              np.uint8)
                        self.done.append(req)
                        completed.append(req)
                        self.latency_hist.observe(now - req.t_submit)
                        if tr.enabled:
                            tr.span("request", "complete", t0=req.t_submit,
                                    t1=now, rid=req.rid, replica=rep.idx)
                wall_s = self._clock() - t_start
                self.acct.record_step(rows=len(work), bucket=d.bucket,
                                      busy_s=busy_s, wall_s=wall_s,
                                      occupancy=occ)
                rep.acct.record_step(rows=len(work), bucket=d.bucket,
                                     busy_s=busy_s, wall_s=wall_s,
                                     occupancy=occ)
                rep.steps += 1
                rep.last_step_s = busy_s
                self.scheduler.observe_step(d.bucket, busy_s, occupancy=occ,
                                            replica=rep.idx)
                rep._work = None
                self._cv.notify_all()
            # callbacks/futures OUTSIDE the lock: user code may submit
            for req, i, lab in live:
                if req.on_image is not None:
                    try:
                        req.on_image(req.rid, i, lab)
                    except Exception:
                        pass   # a streaming callback must not kill serving
            for req in completed:
                self._complete_safely(req.future, result=list(req.labels))

    # -- failure containment (same semantics as the runtime) ----------------

    @staticmethod
    def _complete_safely(future, *, result=None, exc=None) -> None:
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:
            pass   # a cancelled future must never kill a worker

    def _fail_batch(self, rep: _Replica, work, exc: Exception) -> None:
        """A replica's step failed: fail every request with an image in
        that batch (purging their queued remainder), count the replica
        failure, and keep serving."""
        failed = {}
        with self._cv:
            for req, _ in work:
                # purge/count only requests still in flight under their rid:
                # a chunk whose request already failed on ANOTHER replica is
                # purged (and its future failed) there — never twice
                if self._inflight.get(req.rid) is req:
                    failed[req.rid] = req
            if failed:
                self._queue = deque((req, i) for req, i in self._queue
                                    if req.rid not in failed)
                for rid in failed:
                    del self._pending[rid]
                    del self._inflight[rid]
            self.failed_requests += len(failed)
            rep.failures += 1
            rep._work = None
            self._cv.notify_all()
        for req in failed.values():
            self._complete_safely(req.future, exc=exc)

    def _abort(self, exc: BaseException) -> None:
        """Last resort (a bug in fleet bookkeeping): never exit leaving
        accepted futures unresolved."""
        with self._cv:
            self._error = exc
            pending = list(self._inflight.values())
            self._queue.clear()
            self._pending.clear()
            self._inflight.clear()
            self.failed_requests += len(pending)
            self._stopping = True
            for rep in self.replicas:
                rep._work = None
            self._cv.notify_all()
        for req in pending:
            self._complete_safely(
                req.future, exc=RuntimeError(f"fleet died: {exc!r}"))

    # -- replica lifecycle: drain / resume / probe / swap -------------------

    def drain_replica(self, idx: int) -> None:
        """Stop placing new chunks on replica ``idx``; its in-flight step
        completes normally. The rest of the fleet keeps serving."""
        with self._cv:
            rep = self.replicas[idx]
            if rep.state == READY:
                rep.state = DRAINING
            self._cv.notify_all()

    def resume_replica(self, idx: int) -> None:
        """Return a draining replica to the ready pool."""
        with self._cv:
            rep = self.replicas[idx]
            if rep.state == DRAINING:
                rep.state = READY
            self._cv.notify_all()

    def probe(self) -> list:
        """Health probe: one zeros step of the smallest bucket through each
        replica, OFF the request queue (the compiled step is pure, so a
        probe never perturbs serving state). Returns one row per replica:
        state, ok, probe seconds — a stopped/draining replica is reported,
        not probed."""
        rows = []
        for rep in self.replicas:
            with self._cv:
                state, model = rep.state, rep.model
            row = {"replica": rep.idx, "state": state, "ok": False,
                   "probe_s": None}
            if state in (READY, DRAINING):
                try:
                    b = min(model.buckets)
                    t0 = self._clock()
                    out = to_host(model.step(
                        np.zeros(model.input_shape(b), np.uint8)))
                    row["probe_s"] = round(self._clock() - t0, 6)
                    row["ok"] = bool(np.isfinite(out).all())
                except Exception as exc:   # a sick replica is a report,
                    row["error"] = repr(exc)   # not a fleet crash
            with self._cv:
                rep.last_probe_s = row["probe_s"]
            rows.append(row)
        return rows

    def health(self) -> dict:
        """The fleet's lifecycle snapshot: per-replica state machine
        position, step/failure/swap counters, and queue pressure."""
        with self._cv:
            return {
                "replicas": [{
                    "replica": r.idx,
                    "state": r.state,
                    "device": None if r.device is None else str(r.device),
                    "steps": r.steps,
                    "failures": r.failures,
                    "swaps": r.swaps,
                    "warmup_s": (None if r.warmup_s is None
                                 else round(r.warmup_s, 4)),
                    "last_step_s": (None if r.last_step_s is None
                                    else round(r.last_step_s, 6)),
                    "last_probe_s": r.last_probe_s,
                    "busy": r.busy,
                } for r in self.replicas],
                "queued_images": len(self._queue),
                "inflight_requests": len(self._inflight),
                "closing": self._closing,
                "swaps": self.swaps,
            }

    def swap(self, new_model, *, timeout: float | None = None) -> None:
        """Hot-swap a new ``ExecutionPlan``/weights across the fleet, one
        replica at a time, WITHOUT dropping accepted requests.

        The contract: ``new_model`` must keep the template's bucket set
        and input shape (the scheduler and every queued request were
        admitted against them — changing shapes mid-queue would break
        promises already made). Per replica: the candidate is replicated
        onto the replica's device and warmed off-path, the replica drains
        (its in-flight step completes, new chunks route elsewhere), the
        model pointer flips, the replica rejoins ready. Requests accepted
        before, during, and after the swap all resolve."""
        if tuple(new_model.buckets) != tuple(self.model.buckets):
            raise ValueError(
                f"hot-swap must keep the bucket set: fleet serves "
                f"{tuple(self.model.buckets)}, new model compiles "
                f"{tuple(new_model.buckets)}")
        if tuple(new_model.input_shape()[1:]) != \
                tuple(self.model.input_shape()[1:]):
            raise ValueError(
                "hot-swap must keep the input shape: queued requests were "
                "validated against the old spec")
        deadline = None if timeout is None else self._clock() + timeout
        for rep in self.replicas:
            # replicate + warm the candidate OFF-path: the replica keeps
            # serving the old plan while the new one compiles
            candidate = _replica_model(new_model, rep.device)
            if hasattr(candidate, "warmup"):
                candidate.warmup()
            with self._cv:
                if self._closing or self._error is not None:
                    raise RuntimeError("fleet is closed")
                was = rep.state
                if was == READY:
                    rep.state = DRAINING
                self._cv.notify_all()
                while rep._work is not None:
                    if deadline is not None and self._clock() >= deadline:
                        rep.state = was
                        self._cv.notify_all()
                        raise TimeoutError(
                            f"replica {rep.idx} did not drain in time")
                    self._cv.wait(
                        None if deadline is None
                        else max(1e-3, deadline - self._clock()))
                rep.model = candidate
                rep.swaps += 1
                rep.state = READY if was in (READY, DRAINING) else was
                self._cv.notify_all()
        with self._cv:
            self.model = new_model
            self.swaps += 1

    # -- accounting ---------------------------------------------------------

    def stats(self) -> dict:
        """Fleet serving metrics: the shared ServeClient schema plus the
        per-replica table."""
        with self._cv:
            done = list(self.done)
            acct = dataclasses.replace(self.acct)
            queue_peak = self.queue_depth_peak
            extra = {
                "queued_images": len(self._queue),
                "requests_rejected": self.rejected,
                "requests_failed": self.failed_requests,
                "replicas": len(self.replicas),
                "swaps": self.swaps,
                "pace_fps": self.pace_fps,
                "replica_stats": [{
                    "replica": r.idx,
                    "state": r.state,
                    "steps": r.steps,
                    "images": r.acct.images,
                    "failures": r.failures,
                    "busy_s": round(r.acct.busy_s, 4),
                    "fps": round(r.acct.fps, 2),
                    "occupancy": (None if r.acct.occupancy is None
                                  else round(r.acct.occupancy, 4)),
                } for r in self.replicas],
            }
            slo_s = self.scheduler.policy.slo_s
            if slo_s is not None and done:
                within = sum(1 for r in done if r.latency_s <= slo_s)
                extra["slo_ms"] = self.scheduler.policy.slo_ms
                extra["slo_attainment"] = round(within / len(done), 4)
        return serve_stats(acct=acct, done=done,
                           buckets=self.scheduler.buckets,
                           queue_depth_peak=queue_peak,
                           latency_hist=self.latency_hist, extra=extra)
