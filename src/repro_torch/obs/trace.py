"""The disabled tracer (a copy of ``repro.obs.trace.NullTracer``).

Instrumented serving code emits spans only behind ``if tracer.enabled:``,
so with ``NULL_TRACER`` tracing costs one attribute check. Any object with
the reference ``Tracer``'s ``enabled``/``span``/``counter`` surface may be
passed instead.
"""
from __future__ import annotations


class NullTracer:
    """``enabled`` is False and every method is a no-op."""

    enabled = False

    def span(self, category, name, **kw) -> None:
        pass

    def counter(self, name, value, **kw) -> None:
        pass


NULL_TRACER = NullTracer()
