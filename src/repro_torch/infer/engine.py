"""Micro-batching over a ``CompiledModel`` — the serve half of the
compile/serve split (port of ``repro.infer.engine``).

Requests of one or more images enter a queue; the engine drains them
through the model's bucket-shaped steps, fusing images from different
requests into one batch and choosing the cheapest bucket for the backlog
(``batch_buckets=(1, 8)``: a lone image runs the 1-bucket, not 1 padded to
8). ``stats()`` reports the reference's shared schema (v3): fps against the
paper's 30, histogram-backed latency percentiles, pad waste, occupancy.

    model = compile(params, cfg, ExecutionPlan(batch_buckets=(1, 8)))
    eng = MicroBatchEngine(model)
    req = eng.submit(images_u8)        # (n, H, W, C) uint8
    eng.run()                          # drain the queue
    req.labels, eng.stats()

The asynchronous runtime and the fleet (``repro_torch.serve``) share this
module's door check, batch assembly, logits read-back, step accounting and
queue-depth watermark, and speak the same ``ServeClient`` protocol.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import typing
from collections import deque

import numpy as np
import torch

from ..device import borrowed_stream
from ..obs.metrics import Gauge, LatencyHistogram
from ..obs.trace import NULL_TRACER

PAPER_FPS = 30.0   # VESTA's reported real-time Spikformer V2 rate

# Version of the shared ``stats()`` schema; v3 = histogram-backed
# ``latency_*`` fields (<= 5% relative error), as in the reference.
SERVE_STATS_VERSION = 3


@typing.runtime_checkable
class ServeClient(typing.Protocol):
    """The one serving surface of the sync engine, the async runtime and
    the fleet, so drivers (``repro_torch.serve.loadgen``) run against any
    of them: ``submit(images, *, rid=None, on_image=None)`` returns a
    ``Request`` whose ``result()`` yields the labels; ``stats()`` is the
    ``serve_stats`` schema; ``close(timeout=None)`` resolves every
    accepted request before it returns."""

    def submit(self, images, *, rid: int | None = None,
               on_image=None) -> "Request": ...

    def stats(self) -> dict: ...

    def close(self, timeout: float | None = None) -> None: ...


@dataclasses.dataclass
class Request:
    """One classification request: n images in, n labels out.
    ``on_image(rid, index, label)`` fires as each image's batch completes."""
    rid: int
    images: np.ndarray                  # (n, H, W, C) uint8
    labels: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_dequeue: float = 0.0              # first image leaves the queue
    t_done: float = 0.0
    on_image: object = None

    @property
    def latency_s(self) -> float | None:
        """Submit-to-done latency; None while in flight."""
        if not self.t_done:
            return None
        return self.t_done - self.t_submit

    def result(self, timeout: float | None = None) -> list:
        """The labels, draining the engine first if the request is not
        complete yet."""
        if not self.t_done:
            drain = getattr(self, "_drain", None)
            if drain is not None:
                drain()
        if not self.t_done:
            raise RuntimeError(f"request {self.rid} is not complete and has "
                               "no serving loop attached to drain it")
        return list(self.labels)


def validate_images(images, image_shape) -> np.ndarray:
    """A request's images as (n, H, W, C) uint8, checked at the door
    against the model's per-image shape. Other integer dtypes are accepted
    when every pixel is in [0, 255]; floats and bools are rejected."""
    arr = np.asarray(images)
    image_shape = tuple(int(d) for d in image_shape)
    if arr.ndim != 4 or tuple(arr.shape[1:]) != image_shape:
        raise ValueError(
            f"request images have shape {tuple(arr.shape)}; this compiled "
            f"model expects (n, H, W, C) = (n, {image_shape[0]}, "
            f"{image_shape[1]}, {image_shape[2]})")
    if arr.dtype != np.uint8:
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"request images have dtype {arr.dtype}; "
                             "expected uint8 pixel values in [0, 255]")
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) > 255):
            raise ValueError(f"request images of dtype {arr.dtype} contain "
                             "values outside [0, 255]")
        arr = arr.astype(np.uint8)
    return arr


def batch_occupancy(images) -> float:
    """Fraction of set bits across the real rows of an image batch (the
    pixel bits SSSC consumes as value planes); 0.0 when empty. A byte
    popcount: equal as a float to the reference's mean over
    ``np.unpackbits``, since both round the same exact integer count over
    the number of bits, without the eightfold unpacked copy."""
    arr = np.asarray(images, np.uint8).reshape(-1)
    if not arr.size:
        return 0.0
    return int(np.bitwise_count(arr).sum(dtype=np.int64)) / (8 * arr.size)


def assemble_batch(images: list, bucket: int):
    """Stack per-image arrays and zero-pad up to ``bucket`` rows; returns
    ``(batch, pad)``."""
    batch = np.stack(images)
    pad = bucket - len(images)
    if pad:
        batch = np.concatenate(
            [batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
    return batch, pad


def worker_stream(model):
    """The context a serving worker thread runs its steps in: for a model
    on the card, a CUDA stream of its own (``device.borrowed_stream``; a
    step's kernels and its graph replay run on the current stream, so one
    worker's host work can overlap another's device work); nothing for
    other models."""
    device = getattr(model, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return borrowed_stream(device)
    return contextlib.nullcontext()


def to_host(logits) -> np.ndarray:
    """A step's logits as numpy. A tensor comes back through ``.cpu()``,
    which waits for the device: the read-back is where a step
    synchronises, so the time taken around it is the step's real time.
    Stand-in models that return numpy pass through."""
    if isinstance(logits, torch.Tensor):
        return logits.cpu().numpy()
    return np.asarray(logits)


@dataclasses.dataclass
class StepAccounting:
    """Per-step serving accounting: batches, rows, pad waste, timing and
    rows-weighted spike occupancy."""
    batches: int = 0
    images: int = 0
    padded_rows: int = 0
    total_rows: int = 0
    busy_s: float = 0.0         # model-step compute only
    wall_s: float = 0.0         # whole steps incl. batch assembly
    occupancy_weighted: float = 0.0
    occupancy_rows: int = 0

    def record_step(self, *, rows: int, bucket: int, busy_s: float,
                    wall_s: float, occupancy: float | None = None) -> None:
        self.batches += 1
        self.images += rows
        self.padded_rows += bucket - rows
        self.total_rows += bucket
        self.busy_s += busy_s
        self.wall_s += wall_s
        if occupancy is not None:
            self.occupancy_weighted += float(occupancy) * rows
            self.occupancy_rows += rows

    @property
    def pad_waste(self) -> float:
        return self.padded_rows / self.total_rows if self.total_rows else 0.0

    @property
    def occupancy(self) -> float | None:
        if not self.occupancy_rows:
            return None
        return self.occupancy_weighted / self.occupancy_rows

    @property
    def fps(self) -> float:
        """Images per second of step wall time."""
        return self.images / self.wall_s if self.wall_s else 0.0


def latency_summary(latencies_s, *, prefix: str = "latency_") -> dict:
    """Exact p50/p95/p99/mean over per-request latencies, None when
    empty."""
    lat = np.asarray([v for v in latencies_s if v is not None], np.float64)
    if not len(lat):
        return {f"{prefix}{k}": None for k in ("p50_s", "p95_s", "p99_s",
                                               "mean_s")}
    return {
        f"{prefix}p50_s": round(float(np.percentile(lat, 50)), 6),
        f"{prefix}p95_s": round(float(np.percentile(lat, 95)), 6),
        f"{prefix}p99_s": round(float(np.percentile(lat, 99)), 6),
        f"{prefix}mean_s": round(float(lat.mean()), 6),
    }


def serve_stats(*, acct: StepAccounting, done, buckets,
                queue_depth_peak: int = 0,
                latency_hist: LatencyHistogram | None = None,
                extra: dict | None = None) -> dict:
    """The versioned shared ``stats()`` schema (v3)."""
    if latency_hist is not None:
        latency = latency_hist.summary()
    else:
        latency = latency_summary(r.latency_s for r in done)
    out = {
        "stats_version": SERVE_STATS_VERSION,
        "queue_depth_peak": int(queue_depth_peak),
        "requests": len(done),
        "images": acct.images,
        "batches": acct.batches,
        "buckets": list(buckets),
        "wall_s": round(acct.wall_s, 4),
        "fps": round(acct.fps, 2),
        "paper_fps": PAPER_FPS,
        "realtime": bool(acct.wall_s and acct.fps >= PAPER_FPS),
        "padded_rows": acct.padded_rows,
        "total_rows": acct.total_rows,
        "pad_waste": round(acct.pad_waste, 4),
        "occupancy": (None if acct.occupancy is None
                      else round(acct.occupancy, 4)),
        **latency,
    }
    if extra:
        out.update(extra)
    return out


class QueueDepthWatermark:
    """The queue-depth high-watermark every ServeClient reports as
    ``queue_depth_peak``: ``observe`` after every enqueue; ``peak`` is the
    gauge's maximum."""

    __slots__ = ("gauge",)

    def __init__(self, gauge: Gauge | None = None):
        self.gauge = Gauge("queue_depth") if gauge is None else gauge

    def observe(self, depth: int) -> None:
        self.gauge.set(int(depth))

    @property
    def peak(self) -> int:
        return 0 if self.gauge.max is None else int(self.gauge.max)


class MicroBatchEngine:
    """Micro-batching classifier over a multi-bucket ``CompiledModel``.
    ``tracer`` records the request lifecycle spans (admit -> queue ->
    place -> assemble -> step -> complete); ``clock`` is injectable."""

    def __init__(self, model, *, tracer=None, clock=time.perf_counter):
        self.model = model
        self.buckets = tuple(model.buckets)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._clock = clock
        self.queue: deque = deque()         # (request, image index)
        self.done: list[Request] = []
        self._pending: dict[int, int] = {}  # rid -> images left
        self._next_rid = 0
        self._queue_depth = QueueDepthWatermark()
        self.latency_hist = LatencyHistogram()
        self.acct = StepAccounting()

    @property
    def queue_depth_peak(self) -> int:
        return self._queue_depth.peak

    # the reference's accounting names, each a read-only view of ``acct``

    @property
    def batches(self) -> int:
        return self.acct.batches

    @property
    def images_done(self) -> int:
        return self.acct.images

    @property
    def padded_rows(self) -> int:
        return self.acct.padded_rows

    @property
    def total_rows(self) -> int:
        return self.acct.total_rows

    @property
    def busy_s(self) -> float:
        return self.acct.busy_s

    @property
    def wall_s(self) -> float:
        return self.acct.wall_s

    @property
    def pad_waste(self) -> float:
        return self.acct.pad_waste

    def submit(self, images, *, rid: int | None = None,
               on_image=None) -> Request:
        """Queue raw images, or a prebuilt ``Request`` (whose ``rid`` an
        explicit ``rid`` must not contradict), validated against the
        model's input shape here."""
        t_enter = self._clock()
        if isinstance(images, Request):
            req = images
            if rid is not None and rid != req.rid:
                raise ValueError(f"submit(rid={rid}) conflicts with the "
                                 f"Request's own rid={req.rid}")
            if on_image is not None:
                req.on_image = on_image
            req.images = validate_images(req.images,
                                         self.model.input_shape()[1:])
        else:
            arr = validate_images(images, self.model.input_shape()[1:])
            if rid is None:
                rid = self._next_rid
            req = Request(rid=rid, images=arr, on_image=on_image)
        if req.rid in self._pending:
            raise ValueError(f"request id {req.rid} is already in flight")
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.t_submit = self._clock()
        req.labels = [None] * len(req.images)
        req._drain = self.run
        tr = self.tracer
        if not len(req.images):
            req.t_done = req.t_submit
            self.done.append(req)
            self.latency_hist.observe(0.0)
            if tr.enabled:
                tr.span("request", "admit", t0=t_enter, t1=req.t_submit,
                        rid=req.rid, value=0)
                tr.span("request", "complete", t0=req.t_submit,
                        t1=req.t_done, rid=req.rid)
            return req
        self._pending[req.rid] = len(req.images)
        for i in range(len(req.images)):
            self.queue.append((req, i))
        self._queue_depth.observe(len(self.queue))
        if tr.enabled:
            tr.span("request", "admit", t0=t_enter, t1=req.t_submit,
                    rid=req.rid, value=len(req.images))
            tr.counter("queue_depth", len(self.queue), t=req.t_submit)
        return req

    def pick_bucket(self, backlog: int) -> int:
        """The largest bucket while the backlog covers it, else the first
        chunk of the model's pad-minimizing split of the remainder."""
        if backlog >= self.buckets[-1]:
            return self.buckets[-1]
        return self.model.plan_chunks(backlog)[0][1]

    def step(self) -> int:
        """Classify one fused batch drawn across requests; returns #images."""
        if not self.queue:
            return 0
        tr = self.tracer
        t_start = self._clock()
        bucket = self.pick_bucket(len(self.queue))
        t_place = self._clock()
        if tr.enabled:
            tr.span("batch", "place", t0=t_start, t1=t_place, bucket=bucket)
        work = [self.queue.popleft()
                for _ in range(min(bucket, len(self.queue)))]
        t_pop = self._clock()
        if tr.enabled:
            for req, _ in work:
                if not req.t_dequeue:
                    req.t_dequeue = t_pop
                    tr.span("request", "queue", t0=req.t_submit, t1=t_pop,
                            rid=req.rid)
        batch, _ = assemble_batch([req.images[i] for req, i in work], bucket)
        occ = batch_occupancy(batch[:len(work)])  # real rows only
        t0 = self._clock()
        if tr.enabled:
            tr.span("batch", "assemble", t0=t_pop, t1=t0, bucket=bucket,
                    occupancy=occ, value=len(work))
        logits = to_host(self.model.step(batch))
        busy_s = self._clock() - t0
        if tr.enabled:
            tr.span("batch", "step", t0=t0, t1=t0 + busy_s, bucket=bucket,
                    occupancy=occ, value=len(work))
            tr.counter("occupancy", occ, t=t0)
        labels = logits[:len(work)].argmax(axis=-1)
        now = self._clock()
        for (req, i), lab in zip(work, labels):
            req.labels[i] = int(lab)
            self._pending[req.rid] -= 1
            if self._pending[req.rid] == 0:
                del self._pending[req.rid]
                req.t_done = now
                self.done.append(req)
                self.latency_hist.observe(now - req.t_submit)
                if tr.enabled:
                    tr.span("request", "complete", t0=req.t_submit, t1=now,
                            rid=req.rid)
        self.acct.record_step(rows=len(work), bucket=bucket, busy_s=busy_s,
                              wall_s=self._clock() - t_start, occupancy=occ)
        for (req, i), lab in zip(work, labels):
            if req.on_image is not None:
                try:
                    req.on_image(req.rid, i, int(lab))
                except Exception:
                    pass   # a streaming callback must not kill serving
        return len(work)

    def run(self) -> list[Request]:
        """Drain the queue; returns the completed requests."""
        while self.queue:
            self.step()
        return self.done

    def close(self, timeout: float | None = None) -> None:
        """The ServeClient close: drain the queue."""
        self.run()

    def stats(self) -> dict:
        """Serving metrics over everything processed so far (schema v3)."""
        return serve_stats(acct=self.acct, done=self.done,
                           buckets=self.buckets,
                           queue_depth_peak=self.queue_depth_peak,
                           latency_hist=self.latency_hist)
