"""Event-stream workload: DVS ingestion for the packed datapath (port of
``repro.events``).

Sparse event-camera streams are spike-form data already; this package
encodes them straight into the plane-group format the inference stack
runs on (``encoding``), streams them into any ``ServeClient`` as
fixed-duration windows (``session``), and captures/replays the resulting
bursty arrival process deterministically (``trace``). The reference's
``src/repro/events/README.md`` specifies the encoding layout, window
semantics and trace format, which the port keeps."""
from .encoding import (POLARITIES, EventStream, empty_stream,
                       encode_events_to_plane_groups, events_to_frame,
                       flicker_burst_events, merge_streams,
                       moving_edge_events, rasterize_events,
                       window_occupancy)
from .session import EventStreamSession
from .trace import (TRACE_KIND, TRACE_VERSION, EventTrace, TraceArrival,
                    labels_checksum, load_trace, record_trace, replay_trace,
                    trace_to_load)

__all__ = [
    "POLARITIES", "EventStream", "empty_stream",
    "encode_events_to_plane_groups", "events_to_frame", "rasterize_events",
    "window_occupancy", "merge_streams", "moving_edge_events",
    "flicker_burst_events",
    "EventStreamSession",
    "TRACE_VERSION", "TRACE_KIND", "EventTrace", "TraceArrival",
    "record_trace", "load_trace", "replay_trace", "trace_to_load",
    "labels_checksum",
]
