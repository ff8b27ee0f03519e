"""Trace export: Chrome trace-event / Perfetto JSON and a versioned,
re-loadable JSONL span format.

Two formats, two audiences:

* ``write_chrome_trace`` — the `Trace Event Format`_ JSON that
  https://ui.perfetto.dev (and chrome://tracing) loads directly. Layout:
  **one pid per replica** (pid 0 is the single-worker/sync path), a
  ``worker`` tid for batch-scoped spans (assemble/step), a ``scheduler``
  tid for placement, per-request tids for the rid-scoped lifecycle spans
  (concurrent requests must not nest on one thread lane), and **counter
  tracks** ("C" events) for queue depth and occupancy samples.

* ``write_spans_jsonl`` / ``load_spans_jsonl`` — the analysis format
  the reference's ``scripts/trace_report.py`` consumes: a header line carrying
  ``spans_version`` and the tracer's ``dropped_spans`` (loss travels WITH
  the data), then one JSON object per span. ``load_spans_jsonl`` inverts
  it back to ``Span`` records, so a trace file is a first-class input,
  not a write-only artifact.

.. _Trace Event Format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
from __future__ import annotations

import json

from .trace import Span

SPANS_SCHEMA_VERSION = 1
# the reference's kind string: both packages read each other's files
SPANS_KIND = "repro.obs.spans"

# fixed tid lanes inside each replica's pid; request lanes start above them
_TID_WORKER = 0
_TID_SCHEDULER = 1
_TID_SESSION = 2
_TID_REQUEST_BASE = 10

_LANE_NAMES = {_TID_WORKER: "worker", _TID_SCHEDULER: "scheduler",
               _TID_SESSION: "session"}


def _tid_for(span: Span) -> int:
    if span.rid is not None:
        return _TID_REQUEST_BASE + int(span.rid)
    if span.name == "place":
        return _TID_SCHEDULER
    if span.category == "window":
        return _TID_SESSION
    return _TID_WORKER


def to_chrome_trace(spans, *, dropped_spans: int = 0) -> dict:
    """Render spans as a Chrome trace-event dict (Perfetto-loadable).

    Timestamps are rebased to the earliest span (the injected serving
    clock has an arbitrary origin) and scaled to microseconds, the
    format's unit."""
    spans = list(spans)
    t_base = min((s.t0 for s in spans), default=0.0)
    events = []
    seen_pids: dict[int, set] = {}
    for s in spans:
        pid = 0 if s.replica is None else int(s.replica)
        ts = (s.t0 - t_base) * 1e6
        if s.category == "counter":
            seen_pids.setdefault(pid, set())
            events.append({"ph": "C", "name": s.name, "pid": pid, "ts": ts,
                           "args": {s.name: s.value}})
            continue
        tid = _tid_for(s)
        seen_pids.setdefault(pid, set()).add(tid)
        args = {k: v for k, v in (("rid", s.rid), ("bucket", s.bucket),
                                  ("occupancy", s.occupancy),
                                  ("value", s.value)) if v is not None}
        events.append({"ph": "X", "cat": s.category, "name": s.name,
                       "pid": pid, "tid": tid, "ts": ts,
                       "dur": max(0.0, (s.t1 - s.t0) * 1e6), "args": args})
    # metadata: name each replica's process and each fixed lane
    for pid, tids in sorted(seen_pids.items()):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"replica {pid}"}})
        for tid in sorted(tids):
            name = _LANE_NAMES.get(tid, f"request {tid - _TID_REQUEST_BASE}")
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"spans_version": SPANS_SCHEMA_VERSION,
                      "dropped_spans": int(dropped_spans)},
    }


def write_chrome_trace(path, tracer, *, dropped_spans=None) -> int:
    """Write a tracer's spans as Perfetto-loadable JSON; returns the span
    count. Accepts a tracer or a plain span iterable (pass
    ``dropped_spans`` explicitly for the latter)."""
    spans = tracer.spans() if hasattr(tracer, "spans") else list(tracer)
    if dropped_spans is None:
        dropped_spans = getattr(tracer, "dropped_spans", 0)
    doc = to_chrome_trace(spans, dropped_spans=dropped_spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def write_spans_jsonl(path, tracer, *, meta: dict | None = None,
                      dropped_spans=None) -> int:
    """Write the versioned JSONL span file: one header line (schema
    version, span count, ``dropped_spans``, caller ``meta``), then one
    object per span. Returns the span count."""
    spans = tracer.spans() if hasattr(tracer, "spans") else list(tracer)
    if dropped_spans is None:
        dropped_spans = getattr(tracer, "dropped_spans", 0)
    header = {"kind": SPANS_KIND, "spans_version": SPANS_SCHEMA_VERSION,
              "spans": len(spans), "dropped_spans": int(dropped_spans)}
    if meta:
        header["meta"] = dict(meta)
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for s in spans:
            f.write(json.dumps({
                "cat": s.category, "name": s.name,
                "t0": s.t0, "t1": s.t1, "rid": s.rid,
                "replica": s.replica, "bucket": s.bucket,
                "occ": s.occupancy, "value": s.value}) + "\n")
    return len(spans)


def load_spans_jsonl(path) -> tuple[dict, list[Span]]:
    """Load a span JSONL file back: ``(header, spans)``. Refuses files
    that are not this format or a newer schema than this code reads —
    a silent partial parse would corrupt every downstream report."""
    with open(path) as f:
        first = f.readline()
        if not first.strip():
            raise ValueError(f"{path}: empty file, not a span trace")
        header = json.loads(first)
        if header.get("kind") != SPANS_KIND:
            raise ValueError(
                f"{path}: kind={header.get('kind')!r}, expected "
                f"{SPANS_KIND!r} — not a span trace file")
        version = header.get("spans_version")
        if version != SPANS_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: spans_version={version!r}; this reader speaks "
                f"{SPANS_SCHEMA_VERSION}")
        spans = []
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            spans.append(Span(d["cat"], d["name"], d["t0"], d["t1"],
                              d.get("rid"), d.get("replica"),
                              d.get("bucket"), d.get("occ"),
                              d.get("value")))
    if len(spans) != header.get("spans", len(spans)):
        raise ValueError(
            f"{path}: header promises {header.get('spans')} spans, file "
            f"holds {len(spans)} — truncated trace")
    return header, spans
