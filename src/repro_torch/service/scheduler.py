"""The service scheduler: queue -> admission -> buckets -> batched engine.

Port of `repro/service/scheduler.py`: the same semantics, counters
(``service.*``) and stats keys, less the reference's count of pad lanes.
Where the port differs:

  * `device` (default "cuda") is where every family's plan runs; the
    service never moves to the CPU on its own. `hbm_bytes=None` is the
    card's own memory (`total_memory`) on a CUDA device and
    `DEFAULT_HBM_BYTES` on the CPU (the reference's default, so CPU runs
    price buckets as it does).
  * A bucket is its real scans only: the batched engine runs its lanes
    one after another (core/plan.py `build_batched`), so the service hands
    it the list of lane tensors as they are, with no pad lanes and no
    stacked copy. The reference pads a bucket with zero scans to a power
    of two and stacks it, because each batch size is one compiled vmap
    there; the port's plan runs every batch size through one stage
    composition, so neither is needed.
  * Projection sources are read to HOST memory on the prefetch thread and
    copied to the device at assembly: a load straight to the card from
    another thread would queue its copy on the stream the compute uses.
  * On a mesh the service is SPMD: every rank submits the same scans in
    the same order and runs its own drain(); an in-memory scan is the whole
    (N_p, N_v, N_u) array, of which assembly takes this rank's rows
    (`local_projections`), and a source lane loads this rank's rows. A
    sink on a mesh is written on the serving thread (each rank its own
    shards, synchronised), not behind it: the write's barriers must not
    interleave with the engine's collectives from another thread.
  * The serving thread makes the service's device current before it
    launches anything (the kernel launches on the current stream).
  * A bucket's tickets turn DONE once its volumes are computed on the
    card, not when the launches return, so time-to-volume and the SLO
    counts are the volume's.

Bucketing rules:

  * Only same-FAMILY scans share a bucket (requests.ScanFamily — identical
    geometry, mesh and plan pins; the batched engine runs every lane
    through one plan).
  * A bucket holds at most the largest b <= `max_batch` with
    b * footprint(plan) <= hbm_bytes less the open streams' resident state
    (planner/feasibility prices one scan's per-rank footprint; the batched
    engine replicates it per lane), and runs exactly its scans' lanes.

Scheduling (the cross-family order buckets execute in, `policy=`):

  fifo            round-robin across families in arrival order — each round
                  serves at most one bucket per family, so a chatty family
                  cannot starve a quiet one (the fairness baseline).
  largest_bucket  round-robin rounds ordered by bucket size descending —
                  maximize lane occupancy first while keeping the
                  one-bucket-per-family-per-round fairness bound.
  deadline        earliest-deadline-first across ALL buckets (a bucket's
                  deadline is its most urgent ticket's); deadline-less
                  buckets sort last in arrival order. Urgency deliberately
                  overrides fairness — an SLO is a promise.

Serving modes:

  drain()               synchronous, on the caller's thread (the unit of
                        one scheduling pass).
  serve()/shutdown()    the background drain loop: a dedicated thread waits
                        on a condition variable, wakes on submit() and
                        push(), and runs drain passes whenever work is
                        queued — callers never block, they
                        `ticket.wait(timeout=)`. One persistent
                        SourcePrefetcher spans all passes (extend() per
                        pass — no thread churn), and a pass that raises is
                        counted and survived: the loop must keep serving
                        (graceful degradation).

Streams (a scan whose projections arrive while the scanner rotates, the
paper's instant CT): `open_stream()` admits a family whose plan has
schedule="incremental" and builds its `IncrementalSession`; `push()` queues
one delta of raw projections for angles [lo, hi), checked on the caller's
thread against the angles the stream's earlier pushes claimed. A pass folds
the queued deltas in arrival order before its buckets and again after each
bucket, on the serving thread; the delta that completes the stream's angles
also runs the epilogue, and its ticket turns DONE once the volume is
computed. Its `arrived_at` is that delta's arrival, so the time to volume
and the SLO count from the last projection. Admission prices each open
stream's resident accumulator (planner/feasibility
`session_resident_bytes`) against the memory budget, next to the largest
bucket of a pass being served; whole scans and buckets get the budget the
open streams leave. A fold that raises fails its own stream only, and
close() fails every stream still open.
While a stream is open the serve loop polls for work rather than sleeping
(`_serve_loop`).

I/O overlap: all admitted scans' projection loads run on a prefetch thread
(double-buffered — scan k+1 loads while scan k computes) and finished
volumes are written behind (AsyncWriteback) while the next bucket runs.

Tracing (obs/__init__.py lists the spans): with the process tracer on, the
serving thread's time is spans of its own — waiting for work
(``service.loop.wait``), forming buckets (``service.schedule``), each
bucket's lanes fetched and copied (``service.lane.get``,
``service.lane.h2d``, with the bytes copied) — and each scan's life from
arrival to its terminal state is one async event pair (category ``scan``,
id its scan_id). A stream's folds are ``service.stream.fold`` spans, each
around its session's fenced ``session.fold`` with the fold's device
stages, and its async event runs from its open.
Latencies start at the scan's arrival: `submit(arrived_at=)`, submit time
by default; a stream's at its last delta's `push(arrived_at=)`.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from concurrent.futures import Future

import numpy as np
import torch

from ..core.distributed import SCATTER_REDUCES, local_projections
from ..core.geometry import CBCTGeometry
from ..device import resolve_device
from ..io.streams import AsyncWriteback, SourcePrefetcher
from ..obs.metrics import DEFAULT_TIME_BUCKETS, MetricsRegistry
from ..obs.trace import get_tracer, wait_for
from ..planner import (
    DEFAULT_HBM_BYTES, check_feasible, plan_footprint, point_from_plan,
)
from ..planner.feasibility import session_resident_bytes

from .plan_cache import PlanCache
from .requests import (
    AdmissionError, QueueFullError, ScanFamily, ScanTicket, TicketState,
    _QueuedDelta, _QueuedScan, _Stream,
)

#: Cross-family bucket execution orders `ReconstructionService(policy=)`
#: accepts — see the module docstring for their semantics.
SCHEDULING_POLICIES = ("fifo", "largest_bucket", "deadline")

#: Seconds between the serve loop's looks for work while a stream is open
#: (`_serve_loop`).
POLL_S = 50e-6


class _Bucket(NamedTuple):
    """One schedulable unit: same-family scans sharing a batched dispatch.
    `seq` is the bucket's earliest admission sequence number — the
    arrival-order key every policy tie-breaks on. `footprint` is what its
    dispatch holds on a device: its scan count times one scan's
    footprint."""

    family: ScanFamily
    scans: List[_QueuedScan]
    seq: int
    footprint: int

    def deadline(self) -> float:
        """The bucket's most urgent ticket deadline (+inf when no lane
        carries an SLO) — the EDF sort key."""
        ds = [s.ticket.deadline for s in self.scans
              if s.ticket.deadline is not None]
        return min(ds) if ds else math.inf


def _trace_scan(ticket: ScanTicket, t_end: float, tracer,
                t_start: Optional[float] = None) -> None:
    """The scan's life, from its arrival (`t_start`: a stream's open) to
    `t_end` (its terminal transition), as one async event pair of category
    ``scan``."""
    t_start = ticket.start if t_start is None else t_start
    if tracer.enabled and t_start is not None:
        tracer.async_pair("scan", ticket.scan_id, round(t_start * 1e9),
                          round(t_end * 1e9), cat="scan",
                          state=ticket.state.value)


class ReconstructionService:
    """Multi-scan reconstruction front end over one device fleet (mesh).

    mesh         : the fixed fleet every scan is served on (a DeviceMesh;
                   None = single device). Part of every scan family.
    device       : where every plan runs ("cuda" by default; on a mesh,
                   each rank's current device of that type).
    spec         : plan spec families resolve through ("auto" = planner
                   search, once per family — see PlanCache).
    max_batch    : bucket-size ceiling.
    max_queue    : admission bound on queued scans (QueueFullError beyond).
    hbm_bytes    : per-device memory budget for admission + bucket sizing
                   (None: the card's total memory; DEFAULT_HBM_BYTES on
                   the CPU).
    vmem_budget  : the kernel's per-block shared-memory budget (None: the
                   card's opt-in maximum), as in the plan.
    policy       : cross-family bucket scheduling order (SCHEDULING_POLICIES).
    """

    def __init__(self, mesh=None, *, device="cuda", spec: str = "auto",
                 max_batch: int = 8,
                 max_queue: int = 64, hbm_bytes: Optional[int] = None,
                 vmem_budget: Optional[int] = None,
                 plan_cache_capacity: int = 32, prefetch_depth: int = 2,
                 writeback_depth: int = 2, policy: str = "fifo"):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if policy not in SCHEDULING_POLICIES:
            raise ValueError(
                f"policy={policy!r} is not one of {SCHEDULING_POLICIES}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        if hbm_bytes is None:
            hbm_bytes = (torch.cuda.get_device_properties(
                self.device).total_memory if self.device.type == "cuda"
                else DEFAULT_HBM_BYTES)
        self.hbm_bytes = int(hbm_bytes)
        self.vmem_budget = vmem_budget
        self.prefetch_depth = prefetch_depth
        self.policy = policy
        self.plan_cache = PlanCache(capacity=plan_cache_capacity, spec=spec,
                                    device=str(self.device))
        self._writeback = AsyncWriteback(max_pending=writeback_depth)
        self._queue: List[_QueuedScan] = []
        # open streams by scan_id, their pushed deltas not folded yet (in
        # arrival order), and the bytes their sessions hold
        self._streams: Dict[str, _Stream] = {}
        self._deltas: List[_QueuedDelta] = []
        self._stream_bytes = 0
        # the largest bucket footprint of the pass being served (0 between
        # passes): open_stream prices a stream next to it
        self._bucket_bytes = 0
        self._lock = threading.Lock()
        # Background-loop wakeup: submit()/push()/shutdown() notify, the
        # serve thread waits. Shares self._lock so queue state and wakeup
        # are one atomic picture.
        self._cv = threading.Condition(self._lock)
        self._serve_thread: Optional[threading.Thread] = None
        self._shutdown_requested = False
        self._seq = 0
        # Per-INSTANCE metrics registry (not the process-global default):
        # two services on one process must not pool their counts, and the
        # tests assert per-service stats. `stats()` is a thin view over it.
        self.metrics = MetricsRegistry()
        self._c = {
            k: self.metrics.counter(f"service.scans.{k}")
            for k in ("submitted", "rejected", "served", "failed",
                      "store_failed")
        }
        for k in ("buckets", "prefetched_loads", "writebacks"):
            self._c[k] = self.metrics.counter(f"service.{k}")
        self._c["slo_met"] = self.metrics.counter("service.slo.met")
        self._c["slo_missed"] = self.metrics.counter("service.slo.missed")
        self._c["loop_passes"] = self.metrics.counter("service.loop.passes")
        self._c["loop_errors"] = self.metrics.counter("service.loop.errors")
        self._c["streams_opened"] = self.metrics.counter(
            "service.streams.opened")
        self._c["stream_deltas"] = self.metrics.counter(
            "service.stream.deltas")
        self._h_queue_wait = self.metrics.histogram(
            "service.queue_wait_seconds", DEFAULT_TIME_BUCKETS)
        self._h_assembly = self.metrics.histogram(
            "service.bucket_assembly_seconds", DEFAULT_TIME_BUCKETS)
        self._h_ttv = self.metrics.histogram(
            "service.time_to_volume_seconds", DEFAULT_TIME_BUCKETS)

    # -- admission -----------------------------------------------------------

    def _admit(self, family: ScanFamily):
        """Resolve the family's plan (cached) and check it serves: the
        schedule must be batchable and one scan's footprint must fit the
        budget left beside the open streams' resident state — the reject
        half of admission; the queue bound is the backpressure half."""
        plan = self.plan_cache.resolve(family)
        if plan.schedule == "incremental":
            # build_batched would raise at drain time; reject NOW so a
            # bad pin never queues work the engine cannot serve.
            raise AdmissionError(
                "scan rejected: schedule='incremental' is stateful "
                "(projections arrive as deltas) and cannot be served by "
                "the batched engine — stream it with open_stream() and "
                "push() its deltas, or pin a batch schedule "
                "(fused/pipelined/chunked)")
        with self._lock:
            held = self._stream_bytes
        ok, reason = check_feasible(family.geometry, point_from_plan(plan),
                                    self.hbm_bytes - held, self.vmem_budget)
        if not ok:
            raise AdmissionError(
                f"scan rejected: plan [{plan.describe()}] does not fit the "
                f"budget ({self.hbm_bytes / 2**30:.2f} GiB HBM, "
                f"{held / 2**30:.2f} GiB of it held by open streams): "
                f"{reason}")
        return plan

    def submit(self, projections=None, *, geometry: CBCTGeometry,
               source=None, sink=None, scan_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               arrived_at: Optional[float] = None, **pins) -> ScanTicket:
        """Admit one scan. Exactly one of `projections` (in-memory
        (N_p, N_v, N_u) array) / `source` (ProjectionSource, loaded by the
        prefetch thread at drain time) carries the data; `sink`
        (VolumeSink) enables write-behind store of the result. `deadline_s`
        is the scan's time-to-volume SLO target (seconds from its arrival;
        counted in `service.slo.met/missed` at completion, and the
        `deadline` policy schedules against it). `arrived_at` is when the
        scan arrived, on the `time.perf_counter()` clock (None: now); the
        queue wait, the time to volume and the deadline are measured from
        it. `pins` are planner pins
        (precision=..., schedule=...) and widen the scan's family. Returns
        the scan's ticket; raises AdmissionError / QueueFullError instead
        of queueing work that cannot be served. Every rejection path counts
        in the `rejected` stat."""
        try:
            return self._submit(projections, geometry=geometry,
                                source=source, sink=sink, scan_id=scan_id,
                                deadline_s=deadline_s, arrived_at=arrived_at,
                                pins=pins)
        except AdmissionError:     # includes QueueFullError
            self._c["rejected"].inc()
            raise

    def _check_queue_bound(self) -> None:
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"scan queue is full ({self.max_queue}); drain() or "
                "shed load")

    def _submit(self, projections, *, geometry: CBCTGeometry, source,
                sink, scan_id, deadline_s, arrived_at, pins) -> ScanTicket:
        if (projections is None) == (source is None):
            raise AdmissionError(
                "pass exactly one of projections= (in-memory scan) or "
                "source= (ProjectionSource to prefetch from)")
        if deadline_s is not None and deadline_s < 0:
            raise AdmissionError(
                f"deadline_s={deadline_s} must be >= 0 (seconds from "
                "arrival)")
        if arrived_at is not None and not (
                math.isfinite(arrived_at)
                and arrived_at <= time.perf_counter()):
            raise AdmissionError(
                f"arrived_at={arrived_at} must be a time.perf_counter() "
                "reading no later than now")
        if projections is not None:
            want = (geometry.n_proj, geometry.n_v, geometry.n_u)
            if tuple(projections.shape) != want:
                raise AdmissionError(
                    f"projections shape {tuple(projections.shape)} does not "
                    f"match the declared geometry {want}")
        # Cheap backpressure check BEFORE the expensive admission step
        # (plan resolve may be a full planner search) — a full queue must
        # not pay for a search it is about to reject.
        with self._lock:
            self._check_queue_bound()
        family = ScanFamily.make(geometry, self.mesh, pins)
        self._admit(family)   # raises AdmissionError on schedule/footprint
        with self._cv:
            self._check_queue_bound()   # re-check: racing submitters
            self._seq += 1
            now = time.perf_counter()
            ticket = ScanTicket(
                scan_id=scan_id or f"scan-{self._seq}", family=family,
                submitted_at=now, deadline_s=deadline_s,
                arrived_at=now if arrived_at is None else arrived_at)
            self._queue.append(_QueuedScan(ticket=ticket,
                                           projections=projections,
                                           source=source, sink=sink,
                                           seq=self._seq))
            self._c["submitted"].inc()
            self._cv.notify_all()       # wake the background drain loop
        return ticket

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- streams -------------------------------------------------------------

    def open_stream(self, *, geometry: CBCTGeometry,
                    scan_id: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    **pins) -> ScanTicket:
        """Admit one streamed scan: its projections come later, as deltas
        (`push`). `pins` (and the service's spec) must resolve the family
        to a plan with schedule="incremental"; its session, and so its
        resident accumulator, is built here. `deadline_s` is counted from
        the arrival of the delta that completes the angles. Raises
        AdmissionError when the plan is not incremental, when the stream's
        footprint does not fit the budget next to the open streams'
        resident state and the largest bucket of a pass being served
        (planner/feasibility), or when `scan_id` is open
        already, and QueueFullError when `max_queue` streams are open. Every
        rejection counts in the `rejected` stat."""
        try:
            return self._open_stream(geometry, scan_id, deadline_s, pins)
        except AdmissionError:
            self._c["rejected"].inc()
            raise

    def _check_stream_bound(self) -> None:
        if len(self._streams) >= self.max_queue:
            raise QueueFullError(
                f"{self.max_queue} streams are open; finish one or shed "
                "load")

    def _open_stream(self, geometry, scan_id, deadline_s, pins
                     ) -> ScanTicket:
        if deadline_s is not None and deadline_s < 0:
            raise AdmissionError(
                f"deadline_s={deadline_s} must be >= 0 (seconds from the "
                "last delta's arrival)")
        with self._lock:
            self._check_stream_bound()
        family = ScanFamily.make(geometry, self.mesh, pins)
        plan = self.plan_cache.resolve(family)
        if plan.schedule != "incremental":
            raise AdmissionError(
                f"stream rejected: plan [{plan.describe()}] has "
                f"schedule={plan.schedule!r}; a stream folds its deltas "
                "into an incremental session — pin schedule='incremental' "
                "(or submit() the whole scan)")
        point = point_from_plan(plan)
        resident = session_resident_bytes(geometry, point)
        with self._lock:
            self._check_stream_bound()
            held = self._stream_bytes + self._bucket_bytes
            ok, reason = check_feasible(geometry, point,
                                        self.hbm_bytes - held,
                                        self.vmem_budget)
            if not ok:
                raise AdmissionError(
                    f"stream rejected: plan [{plan.describe()}] does not fit "
                    f"next to {len(self._streams)} open streams' "
                    f"{self._stream_bytes / 2**30:.2f} GiB and a bucket's "
                    f"{self._bucket_bytes / 2**30:.2f} GiB (budget "
                    f"{self.hbm_bytes / 2**30:.2f} GiB HBM): {reason}")
            self._stream_bytes += resident   # held against racing openers
        try:
            session = plan.build_incremental()
        except Exception as e:
            with self._lock:
                self._stream_bytes -= resident
            raise AdmissionError(f"stream rejected: {e!r}") from e
        with self._lock:
            self._seq += 1
            scan_id = scan_id or f"scan-{self._seq}"
            if scan_id in self._streams:
                self._stream_bytes -= resident
                raise AdmissionError(f"stream {scan_id!r} is open already")
            now = time.perf_counter()
            ticket = ScanTicket(scan_id=scan_id, family=family,
                                submitted_at=now, deadline_s=deadline_s,
                                arrived_at=now)
            self._streams[scan_id] = _Stream(
                ticket=ticket, session=session,
                claimed=np.zeros(geometry.n_proj, dtype=bool),
                resident=resident, opened_at=now)
            self._c["submitted"].inc()
            self._c["streams_opened"].inc()
        return ticket

    def push(self, ticket: ScanTicket, delta, angle_slice, *,
             arrived_at: Optional[float] = None) -> None:
        """Queue one delta of the open stream `ticket`: the raw projections
        of angles `angle_slice` (a slice or (lo, hi)), (hi - lo, N_v, N_u)
        of them (on a mesh, this rank's share), best already on the
        service's device (elsewhere they are copied at the fold). The
        serving thread folds queued deltas in arrival order; the delta
        that completes the stream's angles runs the epilogue too, and its
        `arrived_at` (a `time.perf_counter()` reading no later than now;
        None: now) becomes the ticket's, so the time to volume counts from
        the last projection. Raises AdmissionError, counted as `rejected`,
        for a stream this service does not hold open (unknown, finished or
        failed), a slice out of range, over angles pushed already or not
        dividing over the rank grid, or a delta of the wrong shape;
        QueueFullError when `max_queue` deltas wait to be folded."""
        try:
            self._push(ticket, delta, angle_slice, arrived_at)
        except AdmissionError:
            self._c["rejected"].inc()
            raise

    def _push(self, ticket, delta, angle_slice, arrived_at) -> None:
        now = time.perf_counter()
        if arrived_at is not None and not (math.isfinite(arrived_at)
                                           and arrived_at <= now):
            raise AdmissionError(
                f"arrived_at={arrived_at} must be a time.perf_counter() "
                "reading no later than now")
        with self._cv:
            stream = self._streams.get(ticket.scan_id)
            if stream is None or stream.ticket is not ticket:
                raise AdmissionError(
                    f"delta rejected: stream {ticket.scan_id!r} is not open "
                    "on this service (finished, failed, or never opened "
                    "here)")
            if len(self._deltas) >= self.max_queue:
                raise QueueFullError(
                    f"delta queue is full ({self.max_queue}); drain() or "
                    "shed load")
            try:
                lo, hi = stream.session.check(delta, angle_slice,
                                              taken=stream.claimed)
            except ValueError as e:
                raise AdmissionError(f"delta rejected: {e}") from e
            stream.claimed[lo:hi] = True
            final = bool(stream.claimed.all())
            at = now if arrived_at is None else arrived_at
            if final:
                ticket.arrived_at = at
            self._deltas.append(_QueuedDelta(stream=stream, delta=delta,
                                             lo=lo, hi=hi, arrived_at=at,
                                             final=final))
            self._cv.notify_all()       # wake the background drain loop

    def _fold_streams(self, tracer) -> List[ScanTicket]:
        """Fold every queued delta, in arrival order (deltas pushed
        meanwhile too). Returns the tickets of the streams that ended."""
        ended: List[ScanTicket] = []
        while True:
            with self._lock:
                if not self._deltas:
                    return ended
                item = self._deltas.pop(0)
            ticket = self._fold(item, tracer)
            if ticket is not None:
                ended.append(ticket)

    def _fold(self, item: _QueuedDelta, tracer) -> Optional[ScanTicket]:
        """Fold one delta into its stream's session: the
        ``service.stream.fold`` span around the session's own (fenced when
        traced, one fence a fold, which takes the fold's device stages).
        The final fold runs the epilogue and turns the ticket DONE once the
        volume is computed. Never raises: a fold that fails fails its own
        stream. Returns the ticket when the stream ended."""
        stream = item.stream
        ticket = stream.ticket
        if ticket.terminal:     # failed at an earlier fold
            return None
        t0 = time.perf_counter()
        try:
            with tracer.span("service.stream.fold", scan_id=ticket.scan_id,
                             lo=item.lo, hi=item.hi, final=item.final,
                             wait_ms=1e3 * (t0 - item.arrived_at)):
                ticket._set_state(TicketState.SERVING)
                out = stream.session.update(item.delta, (item.lo, item.hi),
                                            finalize=item.final)
            self._c["stream_deltas"].inc()
            if not item.final:
                return None
            # DONE means the volume is computed, as for a bucket
            wait_for(out)
            t_end = time.perf_counter()
            ticket._set_state(TicketState.DONE, volume=out)
            self._h_ttv.observe(t_end - ticket.start)
            self._observe_slo(ticket, t_end)
            self._c["served"].inc()
        except Exception as e:
            t_end = time.perf_counter()
            ticket._set_state(TicketState.FAILED, error=e)
            self._observe_slo(ticket, t_done=None)
            self._c["failed"].inc()
        self._end_stream(stream, t_end, tracer)
        return ticket

    def _end_stream(self, stream: _Stream, t_end: float, tracer) -> None:
        """Forget a stream that is DONE or FAILED: its session (and so its
        accumulator) and its share of the memory budget go."""
        with self._lock:
            if self._streams.get(stream.ticket.scan_id) is stream:
                del self._streams[stream.ticket.scan_id]
                self._stream_bytes -= stream.resident
        stream.session = None
        _trace_scan(stream.ticket, t_end, tracer, t_start=stream.opened_at)

    # -- bucketing -----------------------------------------------------------

    def _bucket_capacity(self, family: ScanFamily, plan) -> Tuple[int, int]:
        """(the largest bucket, up to `max_batch` scans, that the budget
        left beside the open streams admits for this family, one scan's
        footprint); the bucket is >= 1: single-scan feasibility was checked
        at admission."""
        fp = plan_footprint(family.geometry, point_from_plan(plan))
        per_scan = max(1, fp.total)
        with self._lock:
            budget = self.hbm_bytes - self._stream_bytes
        return max(1, min(self.max_batch, budget // per_scan)), per_scan

    def _make_buckets(self) -> Tuple[List[_Bucket], List[ScanTicket]]:
        """Drain the queue into policy-ordered buckets, preserving
        submission order within each family. Returns (buckets, failed):
        a family whose plan resolve / capacity sizing raises fails ONLY
        its own tickets (state FAILED, error recorded, `failed` counted)
        and the other families still get buckets (the queue is already
        swapped out here: an exception escaping would strand every pending
        ticket of every family in QUEUED)."""
        with self._lock:
            pending, self._queue = self._queue, []
        by_family: Dict[ScanFamily, List[_QueuedScan]] = {}
        order: List[ScanFamily] = []
        for item in pending:
            fam = item.ticket.family
            if fam not in by_family:
                by_family[fam] = []
                order.append(fam)
            by_family[fam].append(item)
        buckets: List[_Bucket] = []
        failed: List[ScanTicket] = []
        for fam in order:
            scans = by_family[fam]
            try:
                plan = self.plan_cache.resolve(fam)
                cap, per_scan = self._bucket_capacity(fam, plan)
            except BaseException as e:
                t_end = time.perf_counter()
                for item in scans:
                    item.ticket._set_state(TicketState.FAILED, error=e)
                    self._observe_slo(item.ticket, t_done=None)
                    _trace_scan(item.ticket, t_end, get_tracer())
                    failed.append(item.ticket)
                self._c["failed"].inc(len(scans))
                continue
            for i in range(0, len(scans), cap):
                chunk = scans[i:i + cap]
                buckets.append(_Bucket(fam, chunk, chunk[0].seq,
                                       len(chunk) * per_scan))
        return self._schedule(buckets), failed

    def _schedule(self, buckets: List[_Bucket]) -> List[_Bucket]:
        """Order buckets for execution per `self.policy` (module docstring).
        In-family order is always preserved (buckets chunk the family's
        arrival order); the policy decides the CROSS-family interleave."""
        if self.policy == "deadline":
            # EDF across all buckets; ties (and the deadline-less tail,
            # +inf) fall back to arrival order.
            return sorted(buckets, key=lambda b: (b.deadline(), b.seq))
        per_fam: Dict[ScanFamily, List[_Bucket]] = {}
        for b in buckets:
            per_fam.setdefault(b.family, []).append(b)
        out: List[_Bucket] = []
        while per_fam:
            # One bucket per family per round = the fairness bound: a
            # family with B queued buckets delays any other family by at
            # most one bucket per round, never by all B.
            if self.policy == "largest_bucket":
                round_order = sorted(
                    per_fam, key=lambda f: (-len(per_fam[f][0].scans),
                                            per_fam[f][0].seq))
            else:   # fifo
                round_order = sorted(per_fam,
                                     key=lambda f: per_fam[f][0].seq)
            for fam in round_order:
                q = per_fam[fam]
                out.append(q.pop(0))
                if not q:
                    del per_fam[fam]
        return out

    # -- serving -------------------------------------------------------------

    def _load_jobs(self, buckets: List[_Bucket]):
        """One prefetch job per admitted scan, in processing order: sources
        read this rank's rows (and decode) to host memory on the worker
        thread; in-memory scans pass through untouched."""
        jobs = []
        for bucket in buckets:
            for item in bucket.scans:
                if item.source is not None:
                    jobs.append(
                        lambda s=item.source: s.load(self.mesh, device="cpu"))
                else:
                    jobs.append(lambda p=item.projections: p)
        return jobs

    def _observe_slo(self, ticket: ScanTicket,
                     t_done: Optional[float]) -> None:
        """Count the ticket against its SLO: met iff the volume landed
        (t_done) before the absolute deadline; a FAILED ticket
        (t_done=None) with a deadline is a miss. Counted once, at the
        dispatch-side terminal transition (the same instant the
        time-to-volume histogram observes) — a later write-behind store
        failure flips the state but not the SLO count."""
        deadline = ticket.deadline
        if deadline is None:
            return
        if t_done is not None and t_done <= deadline:
            self._c["slo_met"].inc()
        else:
            self._c["slo_missed"].inc()

    def _lane(self, item: _QueuedScan, data, tracer) -> torch.Tensor:
        """One scan's lane on the device: this rank's rows of an in-memory
        scan (all of it without a mesh), or a source's loaded rows. Its
        copy is the ``service.lane.h2d`` span: `bytes` copied to the
        device (0 when the scan is a tensor on it already, `src`
        "device"), `src`, `pinned` (page-locked host memory) and
        `scan_id`."""
        if item.source is None and self.mesh is not None:
            data = local_projections(data, self.mesh)
        with tracer.span("service.lane.h2d") as sp:
            lane = torch.as_tensor(data, dtype=torch.float32,
                                   device=self.device)
            if tracer.enabled:
                on_device = (isinstance(data, torch.Tensor)
                             and data.device == lane.device)
                sp.set(bytes=0 if on_device
                       else lane.numel() * lane.element_size(),
                       src="device" if on_device else "host",
                       pinned=bool(isinstance(data, torch.Tensor)
                                   and data.device.type == "cpu"
                                   and data.is_pinned()),
                       scan_id=item.ticket.scan_id)
        return lane

    def _store(self, item: _QueuedScan, vol, layout, spec) -> Future:
        """Hand a finished volume to its sink: written behind without a
        mesh; on a mesh written here, each rank its own shards (the write
        synchronises the ranks, so it stays on the serving thread). A
        failed write surfaces through the returned future either way."""
        if self.mesh is None:
            return self._writeback.submit(item.sink, vol, layout=layout)
        fut: Future = Future()
        try:
            fut.set_result(item.sink.write(vol, layout=layout,
                                           mesh=self.mesh, spec=spec))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def _serve_bucket(self, bucket: _Bucket, prefetch: SourcePrefetcher,
                      writes: List[Tuple[ScanTicket, object]],
                      tracer) -> List[ScanTicket]:
        """Serve one bucket: consume its prefetched lanes, dispatch the
        batched engine on them, hand sink-ed volumes to the write-behind
        pool. Never raises — a failure fails exactly this bucket's
        tickets."""
        fam, scans = bucket.family, bucket.scans
        bucket_span = tracer.span("service.bucket", scans=len(scans))
        bucket_span.__enter__()
        t_bucket0 = time.perf_counter()
        tickets = [s.ticket for s in scans]
        for t in tickets:
            t._set_state(TicketState.BATCHED)
            if t.start is not None:
                self._h_queue_wait.observe(t_bucket0 - t.start)
        if tracer.enabled:
            bucket_span.set(
                scan_ids=[t.scan_id for t in tickets],
                queue_ms=[None if t.start is None
                          else 1e3 * (t_bucket0 - t.start) for t in tickets])
        # Consume EXACTLY len(scans) prefetch items FIRST, before
        # anything else in the bucket can fail: the prefetch queue
        # is positional (load job k belongs to scan k), so a
        # bucket that bailed early (plan resolve / engine build
        # raising) would leave its loads queued and the NEXT
        # bucket's get() calls would receive them — silent
        # cross-scan data corruption. A failed load fails this
        # bucket only; alignment is preserved either way.
        asm_span = tracer.span("service.bucket.assemble")
        asm_span.__enter__()
        lanes: List[object] = []
        lane_err: Optional[BaseException] = None
        for _ in scans:
            try:
                with tracer.span("service.lane.get"):
                    lanes.append(prefetch.get())
            except BaseException as e:
                lanes.append(None)
                if lane_err is None:
                    lane_err = e
        try:
            if lane_err is not None:
                raise lane_err
            plan = self.plan_cache.resolve(fam)
            engine = plan.build_batched(len(scans))
            lanes = [self._lane(item, l, tracer)
                     for item, l in zip(scans, lanes)]
            n_loads = sum(1 for s in scans if s.source is not None)
            asm_span.__exit__(None, None, None)
            asm_span = None
            self._h_assembly.observe(time.perf_counter() - t_bucket0)
            for t in tickets:
                t._set_state(TicketState.SERVING)
            out = engine(lanes)
            del lanes
            bucket_span.fence(out)
            # DONE means the volume is computed: the launches return
            # before the card finishes, and time-to-volume and the SLOs
            # must read the finish.
            wait_for(out)
            layout, spec = None, plan.output_spec()
            if (plan.schedule == "chunked"
                    and plan.reduce in SCATTER_REDUCES):
                layout = {"kind": "y_chunk_major",
                          "y_chunks": plan.y_chunks}
            t_done = time.perf_counter()
            for i, item in enumerate(scans):
                vol = out[i]
                item.ticket._set_state(TicketState.DONE, volume=vol)
                if item.ticket.start is not None:
                    self._h_ttv.observe(t_done - item.ticket.start)
                self._observe_slo(item.ticket, t_done)
                _trace_scan(item.ticket, t_done, tracer)
                if item.sink is not None:
                    writes.append((item.ticket,
                                   self._store(item, vol, layout, spec)))
            self._c["buckets"].inc()
            self._c["prefetched_loads"].inc(n_loads)
            self._c["served"].inc(len(scans))
            self._c["writebacks"].inc(
                sum(1 for s in scans if s.sink is not None))
        except BaseException as e:
            t_end = time.perf_counter()
            for item in scans:
                ended = item.ticket.terminal   # its life is traced already
                item.ticket._set_state(TicketState.FAILED, error=e)
                if not ended:
                    _trace_scan(item.ticket, t_end, tracer)
                self._observe_slo(item.ticket, t_done=None)
            self._c["failed"].inc(len(scans))
        finally:
            if asm_span is not None:   # bucket failed mid-assembly
                asm_span.__exit__(None, None, None)
            bucket_span.__exit__(None, None, None)
        return tickets

    def _join_writes(self,
                     writes: List[Tuple[ScanTicket, object]]) -> None:
        """Join write-behind stores; a failed write fails ITS ticket only."""
        for ticket, fut in writes:
            try:
                fut.result()
            except BaseException as e:
                ticket._set_state(TicketState.FAILED, error=e)
                # Counters are monotonic: a store failure retracts the scan
                # from the *served* view via its own counter rather than
                # decrementing (stats() reports served - store_failed).
                self._c["store_failed"].inc()
                self._c["failed"].inc()

    def _drain_pass(self,
                    prefetch: Optional[SourcePrefetcher] = None
                    ) -> List[ScanTicket]:
        """One scheduling pass: snapshot the queue, bucket + order it,
        serve every bucket, join the write-behind stores. `prefetch` is
        the serve loop's persistent prefetcher (extended with this pass's
        jobs); None builds a one-shot one (the synchronous drain() path)."""
        tracer = get_tracer()
        served = self._fold_streams(tracer)
        if not self._queue:
            return served
        own_prefetch = prefetch is None
        with tracer.span("service.schedule"):
            buckets, failed = self._make_buckets()
            served.extend(failed)
            if not buckets:
                return served
            with self._lock:
                self._bucket_bytes = max(b.footprint for b in buckets)
            jobs = self._load_jobs(buckets)
            if own_prefetch:
                prefetch = SourcePrefetcher(
                    jobs, depth=self.prefetch_depth).start()
            else:
                prefetch.extend(jobs)
        writes: List[Tuple[ScanTicket, object]] = []
        drain_span = tracer.span("service.drain", n_buckets=len(buckets))
        drain_span.__enter__()
        try:
            for bucket in buckets:
                served.extend(self._serve_bucket(bucket, prefetch, writes,
                                                 tracer))
                served.extend(self._fold_streams(tracer))
        finally:
            with self._lock:
                self._bucket_bytes = 0
            if own_prefetch:
                prefetch.close()
            drain_span.__exit__(None, None, None)
        self._join_writes(writes)
        return served

    def drain(self) -> List[ScanTicket]:
        """Serve every queued scan on the CALLER's thread: fold the queued
        stream deltas, bucket by family, order buckets by the scheduling
        policy, reconstruct each bucket in one batched dispatch, store
        sink-ed results write-behind. Returns the tickets served this
        drain in execution order, with the streams that ended (DONE or
        FAILED — a failed bucket fails only its own tickets, a failed
        fold its own stream). Mutually exclusive with the background loop
        (shutdown() first)."""
        if self.serving:
            raise RuntimeError(
                "drain() is the synchronous serving path, but the "
                "background serve() loop is running — submit() + "
                "ticket.wait() instead, or shutdown() the loop first")
        return self._drain_pass(None)

    # -- the background drain loop -------------------------------------------

    @property
    def serving(self) -> bool:
        """Whether the background drain loop is running."""
        t = self._serve_thread
        return t is not None and t.is_alive()

    def serve(self) -> "ReconstructionService":
        """Start the background drain loop (idempotent): a dedicated
        thread that wakes on submit() and drains whenever scans are
        queued. Callers stop calling drain() and instead
        `ticket.wait(timeout=)` — time-to-volume becomes the service's
        concern (deadline_s SLOs, `service.slo.*` counters), not the
        caller's blocking time."""
        with self._lock:
            if self._serve_thread is not None and self._serve_thread.is_alive():
                return self
            self._shutdown_requested = False
            cuda_index = None
            if self.device.type == "cuda":
                # the caller's current card when the device names none
                cuda_index = (self.device.index if self.device.index
                              is not None else torch.cuda.current_device())
            self._serve_thread = threading.Thread(
                target=self._serve_loop, args=(cuda_index,),
                name="recon-serve", daemon=True)
            self._serve_thread.start()
        return self

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop the background loop GRACEFULLY: scans already queued (and
        any bucket in flight) are served before the thread exits — a
        shutdown never strands admitted work in a non-terminal state.
        Blocks until the loop exits (or `timeout` elapses). Idempotent;
        no-op when the loop never ran."""
        with self._cv:
            self._shutdown_requested = True
            self._cv.notify_all()
        t = self._serve_thread
        if t is not None:
            t.join(timeout)

    def _serve_loop(self, cuda_index: Optional[int]) -> None:
        """The background drain loop body. One persistent prefetcher spans
        every pass (extend() feeds it — no per-pass thread spawn/join);
        a pass that raises is counted in `service.loop.errors` and the
        loop keeps serving (its tickets were already failed by the
        per-bucket / per-family isolation — an unexpected error must not
        take the whole service down with scans still arriving).

        While a stream is open the loop polls for work, POLL_S apart and
        without the lock, instead of sleeping on the condition variable: a
        stream's next delta is due, and waking a thread that sleeps costs
        0.3-0.8 ms on a card's virtual host, all of it on the time to volume
        of a stream's last delta. The sleep between looks leaves the
        interpreter to the threads that push."""
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        prefetch = SourcePrefetcher(depth=self.prefetch_depth,
                                    persistent=True).start()

        def idle() -> bool:
            return (not self._queue and not self._deltas
                    and not self._shutdown_requested)
        try:
            while True:
                with self._cv:
                    while idle():
                        # One span a wait or a poll, so a tracer turned on
                        # meanwhile sees the next.
                        if self._streams:
                            self._cv.release()
                            try:
                                with get_tracer().span("service.loop.poll"):
                                    while idle() and self._streams:
                                        time.sleep(POLL_S)
                            finally:
                                self._cv.acquire()
                            continue
                        # The timeout is a lost-wakeup safety net; normal
                        # wakeup is submit()/push()/shutdown() notifying.
                        with get_tracer().span("service.loop.wait"):
                            self._cv.wait(timeout=0.1)
                    if (not self._queue and not self._deltas
                            and self._shutdown_requested):
                        return
                try:
                    self._drain_pass(prefetch)
                    self._c["loop_passes"].inc()
                except BaseException:
                    self._c["loop_errors"].inc()
        finally:
            prefetch.close()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Counters + cache stats — a thin view over `self.metrics` (the
        per-instance registry), keeping the historical flat keys.
        `plan_cache.searches` staying flat while `submitted` grows is the
        amortization proof (one planner search per scan family);
        `engine_cache` covers the plans' engines (core/plan.py's engine
        cache, one entry a plan). `latency` holds
        the queue-wait / bucket-assembly / time-to-volume histogram
        snapshots; `slo` the met/missed counts and attainment fraction
        over deadline-carrying scans; `loop` the background loop's
        pass/error counts and liveness."""
        from ..core.plan import engine_cache_stats
        v = self.metrics.value
        counters = {
            "submitted": v("service.scans.submitted", 0),
            "rejected": v("service.scans.rejected", 0),
            # store_failed retracts write-behind failures from the served
            # view (monotonic counters cannot decrement).
            "served": (v("service.scans.served", 0)
                       - v("service.scans.store_failed", 0)),
            "failed": v("service.scans.failed", 0),
            "buckets": v("service.buckets", 0),
            "prefetched_loads": v("service.prefetched_loads", 0),
            "writebacks": v("service.writebacks", 0),
        }
        with self._lock:
            counters["queued"] = len(self._queue)
        met = v("service.slo.met", 0)
        missed = v("service.slo.missed", 0)
        counters["slo"] = {
            "met": met,
            "missed": missed,
            "attainment": (met / (met + missed)) if met + missed else None,
        }
        counters["loop"] = {
            "passes": v("service.loop.passes", 0),
            "errors": v("service.loop.errors", 0),
            "serving": self.serving,
        }
        counters["policy"] = self.policy
        with self._lock:
            counters["streams"] = {
                "open": len(self._streams),
                "opened": v("service.streams.opened", 0),
                "deltas": v("service.stream.deltas", 0),
                "resident_bytes": self._stream_bytes,
            }
        counters["latency"] = {
            "queue_wait": self._h_queue_wait.snapshot(),
            "bucket_assembly": self._h_assembly.snapshot(),
            "time_to_volume": self._h_ttv.snapshot(),
        }
        counters["plan_cache"] = self.plan_cache.stats()
        counters["engine_cache"] = engine_cache_stats()
        return counters

    def close(self) -> None:
        """Shut the background loop down (serving queued work first), fail
        every stream still open (its angles never all arrived) and join the
        write-behind pool."""
        if self.serving:
            self.shutdown()
        with self._lock:
            streams = list(self._streams.values())
            self._deltas.clear()
        tracer = get_tracer()
        for stream in streams:
            t_end = time.perf_counter()
            if stream.ticket._set_state(TicketState.FAILED,
                                        error=RuntimeError(
                                            "the service closed with the "
                                            "stream open")):
                self._observe_slo(stream.ticket, t_done=None)
                self._c["failed"].inc()
            self._end_stream(stream, t_end, tracer)
        self._writeback.close()
