"""``EventStreamSession`` — streaming DVS ingestion over any ServeClient
(port of ``repro.events.session``, over the port's ``serve/`` and ``obs/``).

The serving stack speaks requests: ``submit(images) -> handle``. A camera
speaks a continuous event stream. This session is the adapter: feed it
events as they arrive, it accumulates them into fixed-duration windows
(``window_us``), and each time the stream's watermark crosses a window
boundary the closed window is encoded (``events_to_frame`` — a count
frame the SSSC front end consumes natively) and submitted as one request
to whatever ``ServeClient`` backs the session — the sync engine, the
async runtime, or a fleet; the session neither knows nor cares.

Backpressure is the serving stack's existing admission control: a
``QueueFull`` at the submit door SHEDS the window (counted in
``windows_shed``, recorded on the window row) — an event camera cannot
be paused, so under overload the freshest data wins and the loss is
explicit, never a silent buffer. Per-window labels stream back through
the existing per-image callback (``on_window(window, label)`` fires from
the serving worker thread as each window's batch completes).

Every closed window also gets its ingestion-time sparsity readouts —
chunk occupancy (``encoding.window_occupancy``, the ``sparse_budget``
input) and firing rate (``core.spike.packed_occupancy``) over the
window's ``bins``-bin plane-group encoding — so a deployment can
calibrate the sparse route from live traffic before any label returns.

With ``capture=True`` the session records every submitted window's
arrival time and event payload; ``save_trace`` writes the versioned
JSONL trace ``repro_torch.events.trace`` replays deterministically.
"""
from __future__ import annotations

import threading
import time

from ..core.spike import packed_occupancy
from ..obs.trace import NULL_TRACER
from ..serve.scheduler import QueueFull
from .encoding import (EventStream, empty_stream,
                       encode_events_to_plane_groups, events_to_frame,
                       merge_streams, window_occupancy)


class EventStreamSession:
    """Accumulate a DVS event stream into fixed windows and serve them.

        session = EventStreamSession(client, window_us=20_000,
                                     height=16, width=16,
                                     on_window=lambda w, lab: ...)
        session.feed(events)        # any number of times, time-ordered
        session.feed(more_events)
        session.close()             # flush the open window + drain
        session.windows             # per-window rows: occupancy, label...

    ``feed`` is watermark-driven: an incoming event at time t closes every
    window ending at or before t (events are the only clock a sensor
    stream carries). Events older than an already-closed window boundary
    raise — the encoder would have to rewrite a submitted frame, so late
    data is a contract violation, not a silent drop. Windows with no
    events are skipped unless ``submit_empty=True`` (a DVS's silence is
    data, but serving an all-zeros frame is usually wasted work —
    skipping is also what makes a replayed quiet period LOOK quiet to the
    scheduler).
    """

    def __init__(self, client, *, window_us: int, height: int, width: int,
                 bins: int = 8, t0_us: int = 0, on_window=None,
                 submit_empty: bool = False, capture: bool = False,
                 clock=time.perf_counter, tracer=None):
        if window_us < 1:
            raise ValueError(f"window_us must be >= 1, got {window_us!r}")
        if bins < 1 or window_us % bins:
            raise ValueError(
                f"bins must be >= 1 and divide window_us (the occupancy "
                f"readout sub-bins the window); got bins={bins!r}, "
                f"window_us={window_us!r}")
        self.client = client
        self.window_us = int(window_us)
        self.height, self.width = int(height), int(width)
        self.bins = int(bins)
        self.t0_us = int(t0_us)
        self.on_window = on_window
        self.submit_empty = submit_empty
        self.capture = capture
        self._clock = clock
        # window spans ("window"/encode, shed, complete — rid is the window
        # index) land next to the client's request spans when the same
        # tracer is shared, so a Perfetto view shows ingestion and serving
        # on one timeline
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._t_start = None              # wall clock at first feed
        self._open: list[EventStream] = []   # events of the OPEN window
        self._window = 0                  # index of the open window
        self._handles: list = []          # submit handles, arrival order
        self.windows: list[dict] = []     # one row per closed window
        self.captured: list[tuple] = []   # (t_s, window, EventStream)
        self.windows_shed = 0
        self.windows_empty = 0
        self.events_seen = 0
        self._lock = threading.Lock()     # guards label writes (worker thread)

    # -- window bookkeeping -------------------------------------------------

    def _win_start_us(self, w: int) -> int:
        return self.t0_us + w * self.window_us

    def feed(self, events: EventStream) -> None:
        """Ingest a time-ordered batch of events, closing (and serving)
        every window the batch's timestamps move past."""
        if (events.height, events.width) != (self.height, self.width):
            raise ValueError(
                f"events are {events.height}x{events.width} but this "
                f"session serves a {self.height}x{self.width} sensor")
        if not len(events):
            return
        if self._t_start is None:
            self._t_start = self._clock()
        lo = int(events.t_us[0])
        if lo < self._win_start_us(self._window):
            raise ValueError(
                f"event at t_us={lo} precedes the open window starting at "
                f"{self._win_start_us(self._window)}us; window "
                f"{self._window - 1} was already closed and served — a "
                f"stream must be fed in time order")
        self.events_seen += len(events)
        hi = int(events.t_us[-1])
        # the watermark: every window fully before ``hi`` is closeable
        while hi >= self._win_start_us(self._window + 1):
            w_lo = self._win_start_us(self._window)
            w_hi = w_lo + self.window_us
            self._open.append(events.slice_time(w_lo, w_hi))
            self._close_window()
        tail = events.slice_time(self._win_start_us(self._window),
                                 hi + 1)
        if len(tail):
            self._open.append(tail)

    def flush(self) -> None:
        """Close the open window with whatever it holds (end of stream —
        there is no later event to move the watermark)."""
        if self._t_start is None:
            self._t_start = self._clock()
        self._close_window()

    def _close_window(self) -> None:
        w = self._window
        w_lo = self._win_start_us(w)
        events = (merge_streams(*self._open) if self._open
                  else empty_stream(self.height, self.width))
        self._open = []
        self._window += 1
        if not len(events) and not self.submit_empty:
            self.windows_empty += 1
            return
        tr = self.tracer
        t_enc0 = tr.clock() if tr.enabled else 0.0
        planes = encode_events_to_plane_groups(
            events, t=self.bins, window_us=self.window_us // self.bins,
            t0_us=w_lo)
        row = {
            "window": w,
            "t_start_us": w_lo,
            "events": len(events),
            "occupancy": round(window_occupancy(planes, t=self.bins), 4),
            "firing_rate": round(packed_occupancy(planes, self.bins), 4),
            "shed": False,
            "label": None,
        }
        frame = events_to_frame(events)
        t_s = self._clock() - self._t_start
        if self.capture:
            self.captured.append((t_s, w, events.shift_time(-w_lo)))
        # the row must exist BEFORE submit: a synchronous client (the
        # micro-batch engine, a test double) fires the per-image callback
        # inside submit itself
        row_index = len(self.windows)
        self.windows.append(row)
        if tr.enabled:
            # the encode span covers windowing work up to the submit door;
            # rid is the WINDOW index (the session's request id space)
            tr.span("window", "encode", t0=t_enc0, t1=tr.clock(), rid=w,
                    occupancy=row["occupancy"], value=row["events"])
        try:
            handle = self.client.submit(frame[None],
                                        on_image=self._label_cb(row_index))
        except QueueFull:
            self.windows_shed += 1
            row["shed"] = True
            if tr.enabled:
                tr.span("window", "shed", rid=w)
        else:
            self._handles.append(handle)

    def _label_cb(self, row_index: int):
        def cb(rid, image_index, label):
            with self._lock:
                self.windows[row_index]["label"] = int(label)
            tr = self.tracer
            if tr.enabled:
                tr.span("window", "complete",
                        rid=self.windows[row_index]["window"],
                        value=int(label))
            if self.on_window is not None:
                self.on_window(self.windows[row_index]["window"], int(label))
        return cb

    # -- results ------------------------------------------------------------

    def drain(self, timeout: float | None = 60.0) -> None:
        """Block until every submitted window's label has landed."""
        for h in self._handles:
            h.result(timeout=timeout)

    def close(self, timeout: float | None = 60.0) -> None:
        """Flush the open window and drain. The CLIENT stays open — the
        caller owns it (a fleet outlives any one camera session)."""
        self.flush()
        self.drain(timeout=timeout)

    def save_trace(self, path, *, meta: dict | None = None) -> int:
        """Write the captured windows (``capture=True``) as a versioned
        JSONL trace; returns the number of arrivals written. The file
        replays through ``repro_torch.events.replay_trace`` bit-identically."""
        if not self.capture:
            raise ValueError(
                "session was built with capture=False — nothing recorded")
        from .trace import record_trace
        return record_trace(path, height=self.height, width=self.width,
                            window_us=self.window_us, bins=self.bins,
                            arrivals=self.captured, meta=meta)

    def labels(self) -> dict:
        """``{window: label}`` for every served, completed window."""
        with self._lock:
            return {r["window"]: r["label"] for r in self.windows
                    if r["label"] is not None}

    def occupancy_trace(self) -> list:
        """Per-window chunk occupancy, in window order — the live signal
        for sparse-route calibration (feed its running mean to
        ``kernels.lut_matmul.sparse_budget`` / plan calibration)."""
        return [r["occupancy"] for r in self.windows]

    def stats(self) -> dict:
        with self._lock:
            labeled = sum(1 for r in self.windows
                          if r["label"] is not None)
        return {
            "events_seen": self.events_seen,
            "windows_closed": len(self.windows) + self.windows_empty,
            "windows_submitted": len(self._handles),
            "windows_shed": self.windows_shed,
            "windows_empty": self.windows_empty,
            "windows_labeled": labeled,
            "occupancy_mean": (round(float(sum(self.occupancy_trace())
                                           / len(self.windows)), 4)
                               if self.windows else None),
        }
