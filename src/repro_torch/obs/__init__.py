"""Observability: span tracing and the unified metrics registry.

Port of `repro/obs/__init__.py`, with the same exports but one:

  trace.py        nested monotonic-clock spans with explicit fencing (a
                  CUDA event per device, so a span covers dispatch and
                  device compute), thread-safe, near-zero overhead when
                  disabled, exported as Chrome/Perfetto ``trace_event``
                  JSON.
  metrics.py      named counters / gauges / fixed-bucket histograms behind
                  a process-global default registry; the engine cache, the
                  prefetcher and the write-behind executor report through
                  it.

`attribution` (planner predictions joined onto measured stage spans) comes
with the planner: ``obs.attribution`` raises NotImplementedError naming
its ROADMAP.md item.

Quick start::

    from repro_torch import obs
    obs.enable()
    fdk = plan.build(source=src, sink=sink)
    volume = fdk()
    obs.get_tracer().save("trace.json")       # load in ui.perfetto.dev
"""
from . import metrics, trace
from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, counter, default_registry,
    gauge, histogram,
)
from .trace import (
    Span, Tracer, disable, enable, get_tracer, set_tracer, span,
)

__all__ = [
    "metrics", "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
    "default_registry", "gauge", "histogram",
    "Span", "Tracer", "disable", "enable", "get_tracer", "set_tracer",
    "span",
]

ATTRIBUTION_ITEM = ("ROADMAP.md Queue 1 item 22 (traced engines, "
                    "obs.attribution, perf model and planner)")


def __getattr__(name: str):
    if name == "attribution":
        raise NotImplementedError(
            f"obs.attribution is not ported to repro_torch yet; see "
            f"{ATTRIBUTION_ITEM}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
