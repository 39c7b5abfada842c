"""Reconstruction-as-a-service (port of `repro/service`).

The paper solves ONE scan fast; production CT is a *stream* of scans
hitting a fixed fleet. This package is the request layer that turns the
staged engine (core/plan.py) into a throughput machine:

  * scan queue + admission control — requests are rejected up front when
    their footprint cannot fit the memory budget (planner/feasibility) or
    the queue is full (backpressure), never half-served;
  * geometry-bucketed batching — same-family scans (identical geometry,
    mesh, plan pins) share buckets of up to `max_batch` scans, each
    reconstructed by ONE batched engine call over its real scans
    (`ReconstructionPlan.build_batched`), bit-exact per scan vs the
    single-scan engine;
  * plan cache — planner search (`plan_from_spec(g, "auto")`) runs once
    per scan family, not per request; hit/miss/search counters are the
    service's proof of amortization;
  * async I/O overlap — projection reads prefetch ahead to host memory
    (SourcePrefetcher) and volume stores write behind (AsyncWriteback), so
    scan k+1's loads and scan k-1's writes overlap scan k's compute.

    svc = ReconstructionService(mesh)            # device="cuda" by default
    t1 = svc.submit(projections=p1, geometry=g)
    t2 = svc.submit(source=src2, geometry=g, sink=sink2)
    svc.drain()                      # bucket, batch, reconstruct, store
    volume = t1.volume
    svc.stats()["plan_cache"]        # {"searches": 1, "hits": 1, ...}

Continuous serving (the hardened mode): `serve()` starts a background
drain loop — submit() wakes it through a condition variable, callers
`ticket.wait(timeout=)` instead of draining, per-scan `deadline_s`
time-to-volume SLOs are counted in `service.slo.met/missed`, and a
pluggable `policy=` ("fifo" | "largest_bucket" | "deadline") orders
buckets across families with per-family fairness:

    svc = ReconstructionService(mesh, policy="deadline").serve()
    t = svc.submit(projections=p, geometry=g, deadline_s=30.0)
    t.wait(timeout=60); volume = t.result()
    svc.shutdown()                   # graceful: queued work serves first

Figure of merit: scans/hour at a fixed fleet, with SLO attainment.
"""
from .requests import (  # noqa: F401
    AdmissionError, QueueFullError, ScanFamily, ScanTicket, TicketState,
)
from .plan_cache import PlanCache  # noqa: F401
from .scheduler import (  # noqa: F401
    ReconstructionService, SCHEDULING_POLICIES,
)

__all__ = [
    "AdmissionError", "QueueFullError", "ScanFamily", "ScanTicket",
    "TicketState", "PlanCache", "ReconstructionService",
    "SCHEDULING_POLICIES",
]
