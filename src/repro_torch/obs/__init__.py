"""``repro_torch.obs`` — tracing + metrics for the serving stack (a copy of
the reference's ``obs`` package, which imports no framework, so span and
stats artifacts cross between the two packages unchanged).

One tracer surface shared by every ``ServeClient`` (sync engine, async
runtime, fleet); bounded metrics (log-bucket
latency histograms, gauges, counters) backing the shared ``stats()``
schema; Chrome-trace/Perfetto and JSONL export.
"""
from .export import (SPANS_SCHEMA_VERSION, load_spans_jsonl, to_chrome_trace,
                     write_chrome_trace, write_spans_jsonl)
from .metrics import Counter, Gauge, LatencyHistogram, MetricsRegistry
from .trace import (LIFECYCLE, NULL_TRACER, NullTracer, Span, Tracer)

__all__ = [
    "LIFECYCLE",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "MetricsRegistry",
    "SPANS_SCHEMA_VERSION",
    "load_spans_jsonl",
    "to_chrome_trace",
    "write_chrome_trace",
    "write_spans_jsonl",
]
