"""Observability: span tracing, the unified metrics registry, and planner
predicted-vs-measured attribution.

Port of `repro/obs/__init__.py`, with the same exports:

  trace.py        nested monotonic-clock spans with explicit fencing (a
                  CUDA event per device, so a span covers dispatch and
                  device compute), thread-safe, near-zero overhead when
                  disabled, exported as Chrome/Perfetto ``trace_event``
                  JSON.
  metrics.py      named counters / gauges / fixed-bucket histograms behind
                  a process-global default registry; the engine cache, the
                  prefetcher and the write-behind executor report through
                  it.
  attribution.py  joins measured engine-stage spans onto the planner's
                  `PerfBreakdown` prediction — per-stage model error.

Quick start::

    from repro_torch import obs
    obs.enable()
    fdk = plan.build_traced(source=src, sink=sink)
    volume = fdk()
    obs.get_tracer().save("trace.json")       # load in ui.perfetto.dev
    print(obs.attribution.render_report(
        obs.attribution.compare(plan, obs.get_tracer())))
"""
from . import attribution, metrics, trace
from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, counter, default_registry,
    gauge, histogram,
)
from .trace import (
    Span, Tracer, disable, enable, get_tracer, set_tracer, span,
)

__all__ = [
    "attribution", "metrics", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
    "default_registry", "gauge", "histogram",
    "Span", "Tracer", "disable", "enable", "get_tracer", "set_tracer",
    "span",
]

