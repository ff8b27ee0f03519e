"""Request-lifecycle tracing: a preallocated ring buffer of span records.

The serving stack (``MicroBatchEngine``, ``AsyncServeRuntime``,
``ServeFleet``, ``EventStreamSession``) emits every request's canonical
lifecycle as spans::

    admit -> queue -> place -> assemble -> step -> complete

plus ``window`` spans from the event-stream session, ``layer`` spans from
``CompiledModel.profile_step``, and ``counter`` samples (queue depth,
occupancy). A span is nine scalar fields — category, name, start, end,
request id, replica, bucket, occupancy, value — and the whole record set
lives in a **preallocated column-oriented ring**: appending writes nine
existing slots under a lock and allocates nothing, so tracing sits on the
serving hot path without feeding the allocator. When the ring wraps, the
OLDEST span is overwritten and ``dropped_spans`` counts the loss loudly —
a trace that silently forgot its beginning would lie about request
chains, so every consumer (``obs.export``, the reference's
``scripts/trace_report.py``) carries the counter alongside the spans.

The untraced path costs one attribute check: every emit site is

    if tracer.enabled:
        tracer.span(...)

and the default ``NULL_TRACER`` answers ``enabled = False``.

Timestamps come from the tracer's **injected clock** (the same policy as
the pure scheduler): a test drives a fake clock and pins the exact span
table, just like the scheduler's decision tables. Emit sites that already
measured ``t0``/``t1`` on the serving clock pass them explicitly; a bare
``span()`` stamps an instant on the tracer's own clock.
"""
from __future__ import annotations

import threading
import time
import typing

SPAN_FIELDS = ("category", "name", "t0", "t1", "rid", "replica", "bucket",
               "occupancy", "value")

# The canonical request lifecycle, in order. ``place``/``assemble``/``step``
# are batch-scoped (rid None — one span covers every request in the fused
# batch); the rid-scoped chain every admitted request completes is
# admit -> queue -> complete.
LIFECYCLE = ("admit", "queue", "place", "assemble", "step", "complete")


class Span(typing.NamedTuple):
    """One structured trace record. ``t0 == t1`` marks an instant event
    (counters, shed markers); ``value`` is the counter sample or a
    span-specific scalar (rows for ``step``, depth for ``queue_depth``)."""
    category: str
    name: str
    t0: float
    t1: float
    rid: int | None = None
    replica: int | None = None
    bucket: int | None = None
    occupancy: float | None = None
    value: float | None = None

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class NullTracer:
    """The disabled tracer: ``enabled`` is False and every method is a
    no-op, so instrumented code pays exactly one attribute check when
    tracing is off. Shared as the module-level ``NULL_TRACER`` default —
    allocating one per client would be the allocation tracing exists to
    avoid."""

    enabled = False
    dropped_spans = 0
    capacity = 0

    def span(self, category, name, **kw) -> None:
        pass

    def counter(self, name, value, **kw) -> None:
        pass

    def spans(self) -> list:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class Tracer:
    """A bounded, thread-safe span recorder.

        tr = Tracer(capacity=65536)
        tr.span("request", "admit", t0=a, t1=b, rid=7)
        tr.counter("queue_depth", 12)
        tr.spans()          # chronological list[Span]
        tr.dropped_spans    # how many oldest spans the ring overwrote

    The ring is column-oriented: nine preallocated Python lists of
    ``capacity`` slots each. ``span()`` writes one slot per column at the
    write head and advances it — O(1), zero allocation, one lock. Span
    objects only materialize in ``spans()``, off the hot path.
    """

    enabled = True

    def __init__(self, capacity: int = 65536, *, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.capacity = int(capacity)
        self.clock = clock
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._head = 0          # next write slot
        self._count = 0         # live spans (<= capacity)
        n = self.capacity
        self._cat = [None] * n
        self._name = [None] * n
        self._t0 = [0.0] * n
        self._t1 = [0.0] * n
        self._rid = [None] * n
        self._replica = [None] * n
        self._bucket = [None] * n
        self._occ = [None] * n
        self._value = [None] * n

    def span(self, category: str, name: str, *, t0: float | None = None,
             t1: float | None = None, rid: int | None = None,
             replica: int | None = None, bucket: int | None = None,
             occupancy: float | None = None,
             value: float | None = None) -> None:
        """Record one span. ``t0`` defaults to now (tracer clock); ``t1``
        defaults to ``t0`` (an instant event)."""
        if t0 is None:
            t0 = self.clock()
        if t1 is None:
            t1 = t0
        with self._lock:
            i = self._head
            self._cat[i] = category
            self._name[i] = name
            self._t0[i] = t0
            self._t1[i] = t1
            self._rid[i] = rid
            self._replica[i] = replica
            self._bucket[i] = bucket
            self._occ[i] = occupancy
            self._value[i] = value
            self._head = (i + 1) % self.capacity
            if self._count == self.capacity:
                self.dropped_spans += 1     # overwrote the oldest span
            else:
                self._count += 1

    def counter(self, name: str, value, *, t: float | None = None,
                replica: int | None = None) -> None:
        """Record one counter sample (queue depth, occupancy) — an instant
        span of category "counter" whose ``value`` is the reading; export
        renders these as Perfetto counter tracks."""
        self.span("counter", name, t0=t, replica=replica,
                  value=float(value))

    def spans(self) -> list[Span]:
        """Every live span, oldest first (chronological append order —
        the ring start, not index 0, after a wrap)."""
        with self._lock:
            n, cap = self._count, self.capacity
            start = (self._head - n) % cap
            out = []
            for k in range(n):
                i = (start + k) % cap
                out.append(Span(self._cat[i], self._name[i], self._t0[i],
                                self._t1[i], self._rid[i], self._replica[i],
                                self._bucket[i], self._occ[i],
                                self._value[i]))
        return out

    def clear(self) -> None:
        """Empty the ring (capacity and ``dropped_spans`` survive — the
        drop counter is an account of loss, not of current contents)."""
        with self._lock:
            self._head = 0
            self._count = 0

    def __len__(self) -> int:
        with self._lock:
            return self._count
