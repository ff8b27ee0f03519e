"""``AsyncServeRuntime`` — asynchronous continuous batching over a
``CompiledModel``.

The sync ``MicroBatchEngine`` is a drain loop: callers enqueue, then one
thread calls ``run()`` and everything completes before it returns — a
closed loop that can only measure throughput. This runtime is the open-loop
half of the serving story: caller threads ``submit()`` into a bounded
thread-safe queue and immediately get a future back; a single background
worker drives the model's bucket steps (one CUDA graph each under
``jit``), fusing images across
requests exactly like the sync engine (same ``assemble_batch``, same
``StepAccounting``, same pad-minimizing split), and completes each
request's future — with optional per-image streaming callbacks — as
batches finish.

Every scheduling *decision* (wait vs dispatch, admission) is delegated to
``ContinuousBatchingScheduler`` — a pure object tested against an injected
clock — so the thread code here contains no policy, just a condition
variable around the queue.

    model = compile(params, cfg, ExecutionPlan(batch_buckets=(2, 8)))
    with AsyncServeRuntime(model, policy=ServePolicy(max_wait_ms=10,
                                                     slo_ms=100)) as rt:
        req = rt.submit(images_u8)         # returns immediately
        labels = req.result(timeout=5)     # block this caller only
    # closing drains the queue; every accepted request completes

Determinism contract: per-image math is row-independent and bucket-
invariant (the multi-bucket parity contract in ``infer.compile``), so an
identical request trace yields bit-identical labels through this runtime
and the sync engine, regardless of how arrivals happened to batch.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..infer.engine import (QueueDepthWatermark, Request, StepAccounting,
                            assemble_batch, batch_occupancy, serve_stats,
                            to_host, validate_images, worker_stream)
from ..obs.metrics import LatencyHistogram
from ..obs.trace import NULL_TRACER
from .scheduler import ContinuousBatchingScheduler, QueueFull, ServePolicy


@dataclasses.dataclass
class AsyncRequest(Request):
    """A ``Request`` plus async completion: a future resolving to the label
    list. The per-image streaming callback ``on_image(rid, index, label)``
    (fired as each image's batch finishes, i.e. possibly before the whole
    request completes) lives on the base ``Request`` — one field, one
    contract, sync and async."""
    future: Future = dataclasses.field(default_factory=Future)

    def result(self, timeout: float | None = None) -> list:
        """Block until every image in this request is classified; returns
        the labels in submit order."""
        return self.future.result(timeout=timeout)


class AsyncServeRuntime:
    """Continuous-batching serving runtime over a ``CompiledModel``.

    Implements the ``ServeClient`` protocol (submit / stats / close).
    Thread-safe ``submit()`` from any number of caller threads; one
    background worker owns the model. ``close()`` (or leaving the context
    manager) drains the queue — every accepted request completes; overload
    is rejected at the door (``QueueFull``), never buffered unboundedly.

    On completion a request's image payload is released (its ``labels``,
    timing, and image COUNT survive) — a long-lived server keeps serving
    history for ``stats()``, not every pixel it ever classified.
    """

    def __init__(self, model, *, policy: ServePolicy | None = None,
                 scheduler: ContinuousBatchingScheduler | None = None,
                 tracer=None):
        if scheduler is not None and policy is not None:
            raise ValueError("pass either policy or a prebuilt scheduler")
        self.model = model
        self.scheduler = (scheduler if scheduler is not None else
                          ContinuousBatchingScheduler(model.buckets, policy))
        # the runtime is wall-clock by design: Condition.wait sleeps real
        # time, so deadlines must be computed on the same clock. Injected
        # clocks (determinism) belong in the pure scheduler, not here —
        # span determinism tests therefore pin the per-request span NAME
        # chain, which is timestamp-free.
        self._clock = time.perf_counter
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._cv = threading.Condition()
        self._queue: deque = deque()        # (request, image index)
        self._pending: dict[int, int] = {}  # rid -> images left
        self._inflight: dict[int, AsyncRequest] = {}   # rid -> request
        self._next_rid = 0
        self.done: list[AsyncRequest] = []
        self.rejected = 0
        self._queue_depth = QueueDepthWatermark()
        self.latency_hist = LatencyHistogram()
        self.acct = StepAccounting()
        self._closing = False
        self._started = False
        self._worker_error: BaseException | None = None
        self.failed_requests = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-serve-worker")

    @property
    def queue_depth_peak(self) -> int:
        return self._queue_depth.peak

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AsyncServeRuntime":
        """Start the worker thread (idempotent; ``submit`` auto-starts)."""
        with self._cv:
            if not self._started:
                self._started = True
                self._thread.start()
        return self

    def close(self, timeout: float | None = None) -> None:
        """Drain the queue and stop the worker. Every accepted request's
        future completes before the worker exits; new submits are refused
        the moment closing begins."""
        with self._cv:
            self._closing = True
            started = self._started
            self._cv.notify_all()
        if started:
            self._thread.join(timeout)

    def __enter__(self) -> "AsyncServeRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submit door --------------------------------------------------------

    def submit(self, images, *, rid: int | None = None,
               on_image=None) -> AsyncRequest:
        """Queue one request; returns immediately with an ``AsyncRequest``
        whose future resolves to the label list.

        Raises ``ValueError`` for malformed images (validated against the
        compiled model's input spec right here, not inside a step),
        ``ValueError`` for an rid already in flight, and ``QueueFull`` when
        admission control rejects the request (bounded queue — the caller
        sheds or retries; nothing is silently buffered).
        """
        t_enter = self._clock()
        arr = validate_images(images, self.model.input_shape()[1:])
        tr = self.tracer
        with self._cv:
            if self._worker_error is not None:
                raise RuntimeError(
                    f"serve worker died: {self._worker_error!r}")
            if self._closing:
                raise RuntimeError("runtime is closed")
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
                # empty request: complete immediately, still counted
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
            if not self._started:
                self._started = True
                self._thread.start()
            self._cv.notify_all()
        return req

    # -- worker -------------------------------------------------------------

    @staticmethod
    def _complete_safely(future: Future, *, result=None, exc=None) -> None:
        """Resolve a future, tolerating a caller who already cancelled it —
        a cancelled future must never kill the worker thread."""
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:
            pass

    def _fail_batch(self, work, exc: Exception) -> None:
        """A model step failed: fail every request with an image in that
        batch (purging their remaining queued images) so their futures
        RAISE instead of blocking forever; serving continues for everyone
        else."""
        failed = {}
        with self._cv:
            for req, _ in work:
                failed.setdefault(req.rid, req)
            self._queue = deque((req, i) for req, i in self._queue
                                if req.rid not in failed)
            for rid in failed:
                self._pending.pop(rid, None)
                self._inflight.pop(rid, None)
            self.failed_requests += len(failed)
        for req in failed.values():
            self._complete_safely(req.future, exc=exc)

    def _abort(self, exc: BaseException) -> None:
        """Last resort (a bug in the worker's own bookkeeping): never exit
        leaving accepted futures unresolved — fail everything pending and
        refuse further submits."""
        with self._cv:
            self._worker_error = exc
            # EVERY in-flight request, including the popped batch the worker
            # was holding when it died — not just what is still queued
            pending = list(self._inflight.values())
            self._queue.clear()
            self._pending.clear()
            self._inflight.clear()
            self.failed_requests += len(pending)
        for req in pending:
            self._complete_safely(
                req.future, exc=RuntimeError(f"serve worker died: {exc!r}"))

    def _worker(self) -> None:
        try:
            with worker_stream(self.model):
                self._worker_loop()
        except BaseException as exc:
            self._abort(exc)
            raise

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    now = self._clock()
                    oldest = (self._queue[0][0].t_submit if self._queue
                              else None)
                    d = self.scheduler.decide(
                        backlog=len(self._queue), oldest_submit_s=oldest,
                        now_s=now, draining=self._closing)
                    if d.action == "dispatch":
                        break
                    if self._closing:      # idle + closing: queue is drained
                        return
                    # "idle": sleep until a submit; "wait": until the window
                    # deadline (a submit may re-open a better decision first)
                    self._cv.wait(d.wait_s if d.action == "wait" else None)
                work = [self._queue.popleft()
                        for _ in range(min(d.rows, len(self._queue)))]
                tr = self.tracer
                if tr.enabled:
                    t_pop = self._clock()
                    tr.span("batch", "place", t0=now, t1=t_pop,
                            bucket=d.bucket, value=len(work))
                    tr.counter("queue_depth", len(self._queue), t=t_pop)
                    for req, _ in work:
                        if not req.t_dequeue:   # first image leaves queue
                            req.t_dequeue = t_pop
                            tr.span("request", "queue", t0=req.t_submit,
                                    t1=t_pop, rid=req.rid)
            # model step OUTSIDE the lock: submits stay concurrent
            try:
                t_start = self._clock()
                batch, _ = assemble_batch([req.images[i] for req, i in work],
                                          d.bucket)
                occ = batch_occupancy(batch[:len(work)])  # real rows only
                t0 = self._clock()
                if tr.enabled:
                    tr.span("batch", "assemble", t0=t_start, t1=t0,
                            bucket=d.bucket, occupancy=occ, value=len(work))
                # the read-back waits for the device: busy_s is the step's
                # real time
                logits = to_host(self.model.step(batch))
                busy_s = self._clock() - t0
                if tr.enabled:
                    tr.span("batch", "step", t0=t0, t1=t0 + busy_s,
                            bucket=d.bucket, occupancy=occ, value=len(work))
                    tr.counter("occupancy", occ, t=t0)
            except Exception as exc:
                self._fail_batch(work, exc)
                continue
            labels = logits[:len(work)].argmax(axis=-1)
            now = self._clock()
            completed = []
            with self._cv:
                for (req, i), lab in zip(work, labels):
                    req.labels[i] = int(lab)
                    self._pending[req.rid] -= 1
                    if self._pending[req.rid] == 0:
                        del self._pending[req.rid]   # rid leaves "in flight"
                        self._inflight.pop(req.rid, None)
                        req.t_done = now
                        # release the image payload (labels/timing stay for
                        # stats): a long-lived server must not accumulate
                        # every served pixel. Shape keeps the image COUNT so
                        # len(req.images) still matches len(req.labels).
                        req.images = np.empty((len(req.labels), 0, 0, 0),
                                              np.uint8)
                        self.done.append(req)
                        completed.append(req)
                        self.latency_hist.observe(now - req.t_submit)
                        if tr.enabled:
                            tr.span("request", "complete", t0=req.t_submit,
                                    t1=now, rid=req.rid)
                self.acct.record_step(rows=len(work), bucket=d.bucket,
                                      busy_s=busy_s,
                                      wall_s=self._clock() - t_start,
                                      occupancy=occ)
                self.scheduler.observe_step(d.bucket, busy_s, occupancy=occ)
            # callbacks/futures OUTSIDE the lock: user code may submit
            for (req, i), lab in zip(work, labels):
                if req.on_image is not None:
                    try:
                        req.on_image(req.rid, i, int(lab))
                    except Exception:
                        pass   # a streaming callback must not kill serving
            for req in completed:
                self._complete_safely(req.future, result=list(req.labels))

    # -- accounting ---------------------------------------------------------

    def stats(self) -> dict:
        """Serving metrics over everything processed so far (thread-safe).

        ``fps`` here is service capacity (images per second of step wall
        time); arrival-bounded numbers — goodput, SLO attainment under a
        real arrival process — come from ``repro_torch.serve.loadgen``.
        """
        with self._cv:
            done = list(self.done)
            rejected = self.rejected
            failed = self.failed_requests
            queued = len(self._queue)
            queue_peak = self.queue_depth_peak
            acct = dataclasses.replace(self.acct)
        extra = {
            "queued_images": queued,
            "requests_rejected": rejected,    # loadgen's spelling: one
            "requests_failed": failed,        # vocabulary across reporters
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
