"""Bounded serving metrics: a counter, a high-watermark gauge, a
log-bucketed latency histogram and the registry that names them (copies
of ``repro.obs.metrics``).

``LatencyHistogram`` holds O(buckets) state however many requests arrive:
bucket edges grow by ``growth`` (default 1.05), so a percentile is within
one bucket width (5% relative) of the exact order statistic, clamped into
the observed [min, max]; the mean is exact.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """A monotonically increasing count (requests, drops, spans)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A last-value reading that also tracks its high-watermark."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None
        self.max: float | None = None

    def set(self, value: float) -> None:
        self.value = value
        if self.max is None or value > self.max:
            self.max = value


class LatencyHistogram:
    """Log-bucketed latency distribution with bounded percentile error;
    thread-safe."""

    def __init__(self, *, lo: float = 1e-6, hi: float = 100.0,
                 growth: float = 1.05):
        if not 0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo!r} hi={hi!r}")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth!r}")
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        n = int(math.ceil((math.log(hi) - self._log_lo) / self._log_growth))
        # +2: an underflow bucket (readings < lo, including 0.0) and an
        # overflow bucket
        self.counts = [0] * (n + 2)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._lock = threading.Lock()

    @property
    def error_bound(self) -> float:
        """Documented worst-case relative percentile error: one bucket
        width."""
        return self.growth - 1.0

    def _index(self, seconds: float) -> int:
        if seconds < self.lo:
            return 0
        if seconds >= self.hi:
            return len(self.counts) - 1
        return 1 + int((math.log(seconds) - self._log_lo) / self._log_growth)

    def observe(self, seconds: float) -> None:
        seconds = float(seconds)
        if seconds < 0:
            raise ValueError(f"latency must be >= 0, got {seconds!r}")
        i = min(self._index(seconds), len(self.counts) - 1)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += seconds
            if self.min is None or seconds < self.min:
                self.min = seconds
            if self.max is None or seconds > self.max:
                self.max = seconds

    def _representative(self, i: int) -> float:
        """A bucket's stand-in: the geometric midpoint of its edges,
        clamped to the observed range."""
        if i == 0:
            v = self.lo
        elif i == len(self.counts) - 1:
            v = self.hi
        else:
            v = self.lo * self.growth ** (i - 1) * math.sqrt(self.growth)
        return max(self.min, min(self.max, v))

    def percentile(self, q: float) -> float | None:
        """The q-th percentile (0..100) by nearest rank, None when empty."""
        with self._lock:
            if not self.count:
                return None
            rank = max(1, math.ceil(q / 100.0 * self.count))
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank:
                    return self._representative(i)
            return self._representative(len(self.counts) - 1)

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def summary(self, *, prefix: str = "latency_") -> dict:
        """``latency_p50_s``/``p95``/``p99``/``mean_s``, all None when
        empty."""
        if not self.count:
            return {f"{prefix}{k}": None for k in ("p50_s", "p95_s",
                                                   "p99_s", "mean_s")}
        return {
            f"{prefix}p50_s": round(self.percentile(50), 6),
            f"{prefix}p95_s": round(self.percentile(95), 6),
            f"{prefix}p99_s": round(self.percentile(99), 6),
            f"{prefix}mean_s": round(self.mean, 6),
        }


class MetricsRegistry:
    """A flat, typed metric namespace: ``counter``/``gauge``/``histogram``
    get-or-create by name, and asking for an existing name as a different
    type fails loudly (two subsystems silently sharing "queue_depth" as
    different shapes is a reporting bug, not a convenience)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, not a "
                    f"{cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, **kw) -> LatencyHistogram:
        return self._get(name, LatencyHistogram,
                         lambda: LatencyHistogram(**kw))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Every metric as plain data: counters to ints, gauges to
        ``{value, max}``, histograms to their summary dict."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = {"value": m.value, "max": m.max}
            else:
                out[name] = {"count": m.count, **m.summary()}
        return out
