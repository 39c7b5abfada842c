"""Observability: span tracing, the unified metrics registry, and planner
predicted-vs-measured attribution.

Port of `repro/obs/__init__.py`, with the same exports:

  trace.py        nested monotonic-clock spans with explicit fencing (a
                  CUDA event per device, so a span covers dispatch and
                  device compute), device stages timed by CUDA event
                  pairs and resolved at the enclosing fence, device-side
                  counts read there too, async per-request events,
                  thread-safe, near-zero overhead when disabled, exported
                  as Chrome/Perfetto ``trace_event`` JSON.
  metrics.py      named counters / gauges / fixed-bucket histograms behind
                  a process-global default registry; the engine cache, the
                  prefetcher and the write-behind executor report through
                  it.
  attribution.py  joins measured engine-stage spans onto the planner's
                  `PerfBreakdown` prediction — per-stage model error.

The serving path (service/scheduler.py, core/plan.py, kernels/), with
the tracer on:

  service.loop.wait        the serve thread waiting for work
  service.loop.poll        the same while a stream is open: it polls
  service.schedule         a pass's buckets formed, its loads queued
  service.drain            one pass over its buckets
  service.bucket           one bucket: args scans, scan_ids, queue_ms
                           (each scan's arrival to the bucket's start);
                           fenced
    service.bucket.assemble   its lanes made device tensors
      service.lane.get        one lane's prefetch wait
      service.lane.h2d        one lane's copy to the device: args bytes,
                              src ("host"/"device"), pinned, scan_id
    engine.batched         the batched engine, fenced: args lanes,
                           device_ms {"stage.filter", "filter.kernel",
                           "stage.backproject", "bp.operands", "bp.kernel",
                           "bp.unfold", "stage.reduce"} summed over its
                           lanes, and direct_pairs / ring_waits /
                           tile_pairs of its kernel launches
  service.stream.fold      one delta of an open stream folded into its
                           session (`open_stream`/`push`): args scan_id,
                           lo, hi, final (the fold that completes the
                           angles and runs the epilogue), wait_ms (the
                           delta's arrival to the fold's start)
    session.fold           the session's fold (core/plan.py
                           IncrementalSession.update), fenced: args lo,
                           hi, final, device_ms {"stage.filter",
                           "filter.kernel", "stage.backproject",
                           "bp.operands", "bp.kernel", "bp.unfold",
                           "stream.accumulate", "stream.finalize"}
  scan (async, cat "scan") one scan's life from arrival to DONE or FAILED
                           (a stream's from its open), id its scan_id

The service counts streams in its own registry:
service.streams.opened and service.stream.deltas (deltas folded).

The kernels count into the default registry: kernels.backproject.launches,
.tile_pairs, .direct_pairs and .ring_waits (the last three for launches
read at a traced fence), kernels.attention.launches and .window_launches, and
kernels.filter.launches and .rows (the detector rows each launch
filtered: every filter_fn call on the card is one launch).

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

