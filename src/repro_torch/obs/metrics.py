"""Unified metrics registry: named counters, gauges, fixed-bucket histograms.

Port of `repro/obs/metrics.py`, plain Python as there (the port keeps its
own copy and imports nothing of `repro`): the same instrument types,
default buckets, naming convention and `snapshot()` shape. The engine
cache (`core/cache.py`, ``cache.core.engine_cache.*``), the prefetcher and
the write-behind executor (`io/streams.py`, ``io.prefetch.*``,
``io.writeback.*``) count through the default registry:

    from repro_torch.obs import metrics
    reg = metrics.default_registry()          # process-global
    reg.counter("io.prefetch.loads").inc()
    reg.gauge("io.prefetch.queue_depth").set(2)
    reg.histogram("io.writeback.write_seconds").observe(0.41)
    reg.snapshot()                            # nested plain-dict view
    print(reg.render())                       # human-readable dump

Naming convention: dotted ``subsystem.object.metric``, lower_snake leaf
names, ``_seconds`` / ``_bytes`` unit suffixes on histograms. Instruments
are get-or-create — asking for an existing name returns the same object
(asking with a different TYPE raises, catching collisions early).

Everything is thread-safe (one lock per instrument, one per registry map)
and dependency-free — `snapshot()` is plain data for tests and CLIs.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "counter", "gauge", "histogram",
    "DEFAULT_TIME_BUCKETS",
]

# Default histogram edges for *_seconds observations: 100 µs .. ~3.4 min in
# x4 steps — wide enough for queue waits and whole-scan latencies without
# per-site tuning. Finite edges only; the +inf overflow bucket is implicit.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * 4 ** i for i in range(11))


class Counter:
    """Monotonic count. `inc()` only goes up; `value` is the running total."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value: set/inc/dec (queue depths, in-flight counts).
    Also records the high-water mark (`max_value`) since creation — depth
    gauges are mostly read *after* the fact, in tests and stats dumps."""

    __slots__ = ("name", "_v", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)
            if self._v > self._max:
                self._max = self._v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n
            if self._v > self._max:
                self._max = self._v

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    @property
    def max_value(self) -> float:
        with self._lock:
            return self._max


class Histogram:
    """Fixed-bucket histogram: cumulative-style bucket counts over the
    configured upper EDGES plus an implicit +inf overflow bucket, with
    count/sum/min/max for mean and range. Edges are per-instrument and
    immutable — a fixed memory footprint per metric, no quantile sketches.
    """

    __slots__ = ("name", "edges", "_counts", "_n", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        edges = tuple(float(e) for e in buckets)
        if not edges:
            raise ValueError(
                f"histogram {name!r} needs at least one bucket edge")
        if any(not math.isfinite(e) for e in edges):
            raise ValueError(
                f"histogram {name!r} bucket edges must be finite "
                "(+inf overflow is implicit)")
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(
                f"histogram {name!r} bucket edges must be strictly "
                f"increasing, got {edges}")
        self.name = name
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)   # last = +inf overflow
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        # first edge >= v (counts are per-bucket; snapshot cumulates)
        i = 0
        for e in self.edges:
            if v <= e:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            n, s = self._n, self._sum
            counts = list(self._counts)
            mn = self._min if n else None
            mx = self._max if n else None
        return {
            "count": n,
            "sum": s,
            "mean": (s / n) if n else None,
            "min": mn,
            "max": mx,
            "buckets": {
                **{f"le_{e:g}": c for e, c in zip(self.edges, counts)},
                "le_inf": counts[-1],
            },
        }


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors and plain-data
    export. One process-global default (`default_registry()`); components
    with per-instance counts own private registries."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        h = self._get_or_create(name, Histogram,
                                lambda: Histogram(name, buckets))
        if tuple(float(b) for b in buckets) != h.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.edges}; re-registration must agree")
        return h

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        """The instrument registered under `name`, or None."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Counter/gauge value by name (`default` when unregistered) — the
        thin-view accessor legacy `stats()` dicts read through."""
        m = self.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return m.snapshot()
        return m.value

    def snapshot(self) -> dict:
        """Plain-dict state of every instrument: counters/gauges to their
        value, histograms to their summary dict."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in sorted(items):
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            elif isinstance(m, Gauge):
                out[name] = {"value": m.value, "max": m.max_value}
            else:
                out[name] = m.value
        return out

    def render(self) -> str:
        """Human-readable one-line-per-metric dump (CLIs, bench footers)."""
        lines = []
        for name, v in self.snapshot().items():
            if isinstance(v, dict) and "buckets" in v:
                mean = v["mean"]
                lines.append(
                    f"{name}: count={v['count']} sum={v['sum']:.6g}"
                    + (f" mean={mean:.6g} min={v['min']:.6g}"
                       f" max={v['max']:.6g}" if v["count"] else ""))
            elif isinstance(v, dict):
                lines.append(f"{name}: {v['value']:g} (max {v['max']:g})")
            else:
                lines.append(f"{name}: {v}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Drop every instrument (tests). Existing instrument OBJECTS held
        by call sites keep counting into the void — call sites that cache
        instruments across resets should re-fetch them."""
        with self._lock:
            self._metrics.clear()


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT_REGISTRY


def counter(name: str) -> Counter:
    return _DEFAULT_REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _DEFAULT_REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return _DEFAULT_REGISTRY.histogram(name, buckets)
