"""Versioned JSONL event-serve traces: capture once, replay bit-identically
(port of ``repro.events.trace``; the file format is the reference's, so a
trace either package writes replays in the other).

A synthetic Poisson trace answers "can the server take R rps"; a captured
trace answers "can the server take THIS traffic" — the bursty ON/OFF
arrival process a real event camera actually produces. This module owns
the file format and the replay:

* ``TRACE_VERSION = 1``, line-oriented JSON. Line 1 is the header::

      {"trace_version": 1, "kind": "event_serve_trace",
       "height": H, "width": W, "channels": 2,
       "window_us": 20000, "bins": 8, "payload": "events",
       "meta": {...}}

  Every following line is one arrival. ``payload: "events"`` carries the
  window's event arrays (timestamps RELATIVE to the window start, so a
  trace is position-independent)::

      {"t_s": 0.31, "window": 15,
       "x": [...], "y": [...], "t_us": [...], "p": [...]}

  ``payload: "counts"`` carries only ``{"t_s": ..., "n_images": n}`` —
  the arrival-process skeleton, for replaying timing against synthetic
  payloads (``meta.image_seed`` feeds ``loadgen.image_maker``).

* ``record_trace`` / ``load_trace`` write and parse that format; loading
  an unknown version or kind fails loud (a replay against a
  misinterpreted trace would "pass" meaninglessly).

* ``replay_trace`` turns a trace into ``loadgen.run_open_loop`` inputs
  (arrivals + a payload maker that re-encodes each window's events into
  a count frame) and drives any ``ServeClient`` with it. Identical trace
  file → identical arrival schedule, identical payload bytes, and — by
  the serving stack's determinism contract — bit-identical labels,
  through 1 replica or N. ``labels_sha`` in the returned metrics is the
  checksum benches gate on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..serve.loadgen import Arrival, image_maker, run_open_loop
from .encoding import POLARITIES, EventStream, events_to_frame

TRACE_VERSION = 1
TRACE_KIND = "event_serve_trace"


@dataclasses.dataclass(frozen=True)
class TraceArrival:
    """One recorded arrival: a window submitted at ``t_s`` (seconds from
    trace start). ``events`` holds the window's payload (timestamps
    window-relative) in an events-payload trace; a counts-payload trace
    carries only ``n_images``."""
    t_s: float
    window: int = 0
    events: EventStream | None = None
    n_images: int = 1


@dataclasses.dataclass(frozen=True)
class EventTrace:
    """A parsed trace: the header fields plus the arrival list."""
    height: int
    width: int
    window_us: int
    bins: int
    payload: str                       # "events" | "counts"
    arrivals: tuple
    channels: int = POLARITIES
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.arrivals[-1].t_s if self.arrivals else 0.0


def record_trace(path, *, height: int, width: int, window_us: int,
                 bins: int, arrivals, payload: str = "events",
                 channels: int = POLARITIES, meta: dict | None = None) -> int:
    """Write a trace file; returns the number of arrivals written.
    ``arrivals`` is an iterable of ``TraceArrival`` (or the
    ``(t_s, window, EventStream)`` tuples ``EventStreamSession.captured``
    collects). Arrival times must be sorted — the same loud contract the
    replay enforces."""
    if payload not in ("events", "counts"):
        raise ValueError(f"payload must be 'events' or 'counts', got "
                         f"{payload!r}")
    header = {"trace_version": TRACE_VERSION, "kind": TRACE_KIND,
              "height": int(height), "width": int(width),
              "channels": int(channels), "window_us": int(window_us),
              "bins": int(bins), "payload": payload, "meta": meta or {}}
    n, prev = 0, 0.0
    with open(path, "w") as fh:
        fh.write(json.dumps(header) + "\n")
        for a in arrivals:
            if isinstance(a, tuple):
                a = TraceArrival(t_s=a[0], window=a[1], events=a[2])
            if a.t_s < prev:
                raise ValueError(
                    f"arrival {n} at t_s={a.t_s!r} precedes its "
                    f"predecessor at {prev!r}; record in time order")
            prev = a.t_s
            row = {"t_s": round(float(a.t_s), 6)}
            if payload == "events":
                if a.events is None:
                    raise ValueError(
                        f"arrival {n} has no events but payload='events'")
                ev = a.events
                row.update(window=int(a.window),
                           x=ev.x.tolist(), y=ev.y.tolist(),
                           t_us=ev.t_us.tolist(),
                           p=ev.polarity.tolist())
            else:
                row["n_images"] = int(a.n_images)
            fh.write(json.dumps(row) + "\n")
            n += 1
    return n


def load_trace(path) -> EventTrace:
    """Parse a trace file, failing loud on anything that is not exactly a
    version-``TRACE_VERSION`` ``event_serve_trace``."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header = json.loads(lines[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(
            f"{path}: kind={header.get('kind')!r} is not a "
            f"{TRACE_KIND!r} trace")
    if header.get("trace_version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace_version={header.get('trace_version')!r} "
            f"unsupported (this reader speaks {TRACE_VERSION})")
    payload = header["payload"]
    h, w = int(header["height"]), int(header["width"])
    arrivals = []
    for ln in lines[1:]:
        row = json.loads(ln)
        if payload == "events":
            arrivals.append(TraceArrival(
                t_s=float(row["t_s"]), window=int(row["window"]),
                events=EventStream(
                    h, w, np.asarray(row["x"], np.int64),
                    np.asarray(row["y"], np.int64),
                    np.asarray(row["t_us"], np.int64),
                    np.asarray(row["p"], np.int64))))
        else:
            arrivals.append(TraceArrival(t_s=float(row["t_s"]),
                                         n_images=int(row["n_images"])))
    return EventTrace(height=h, width=w, channels=int(header["channels"]),
                      window_us=int(header["window_us"]),
                      bins=int(header["bins"]), payload=payload,
                      arrivals=tuple(arrivals), meta=header.get("meta", {}))


def trace_to_load(trace: EventTrace):
    """A trace as open-loop inputs: ``(arrivals, make_images)`` for
    ``run_open_loop``. Events-payload arrivals re-encode each recorded
    window into its count frame (one image per window — identical bytes
    every replay); counts-payload arrivals use the deterministic
    synthetic maker seeded from ``meta.image_seed``."""
    arrivals = [Arrival(t_s=a.t_s, n_images=a.n_images)
                for a in trace.arrivals]
    if trace.payload == "counts":
        seed = int(trace.meta.get("image_seed", 0))
        return arrivals, image_maker(
            (trace.height, trace.width, trace.channels), seed=seed)
    frames = [events_to_frame(a.events) for a in trace.arrivals]

    def make(index: int, n: int):
        return frames[index][None]

    return arrivals, make


def labels_checksum(labels) -> str:
    """A short stable checksum over per-arrival label lists (``None`` for
    a rejected/dropped arrival) — what "bit-identical labels" is gated
    as."""
    blob = json.dumps(labels, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def replay_trace(trace, client, *, slo_ms: float,
                 result_timeout_s: float = 60.0) -> dict:
    """Replay a trace (an ``EventTrace`` or a path) against a FRESH
    ``ServeClient`` and measure. Returns the ``run_open_loop`` metrics
    plus the trace's shape (``windows``, ``trace_duration_s``) and the
    determinism handles: ``labels`` (per-arrival label lists, ``None``
    where admission control shed) and ``labels_sha``.

    The client must be fresh (no prior traffic): replayed labels are
    aligned to arrivals by the submit handles themselves, and the
    serving metrics in ``client.stats()`` would otherwise mix in traffic
    this trace never offered."""
    if not isinstance(trace, EventTrace):
        trace = load_trace(trace)
    arrivals, make_images = trace_to_load(trace)
    handles = {}
    metrics = run_open_loop(
        client, arrivals, make_images, slo_ms=slo_ms,
        result_timeout_s=result_timeout_s,
        on_accept=lambda k, h: handles.__setitem__(k, h))
    labels = []
    for k in range(len(arrivals)):
        h = handles.get(k)
        if h is None:
            labels.append(None)
            continue
        try:
            labels.append(list(h.result(timeout=0.0)))
        except Exception:
            labels.append(None)   # dropped: already counted by the metrics
    return {
        **metrics,
        "windows": len(arrivals),
        "trace_duration_s": round(trace.duration_s, 6),
        "labels": labels,
        "labels_sha": labels_checksum(labels),
    }
