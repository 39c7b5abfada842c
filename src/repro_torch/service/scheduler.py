"""The service scheduler: queue -> admission -> buckets -> batched engine.

Port of `repro/service/scheduler.py`: the same semantics, counters
(``service.*``) and stats keys. Where the port differs:

  * `device` (default "cuda") is where every family's plan runs; the
    service never moves to the CPU on its own. `hbm_bytes=None` is the
    card's own memory (`total_memory`) on a CUDA device and
    `DEFAULT_HBM_BYTES` on the CPU (the reference's default, so CPU runs
    price buckets as it does).
  * Lanes are assembled with `torch.stack` on the device; pad lanes are
    zero tensors of a lane's shape. The batched engine runs its lanes in
    series (core/plan.py `build_batched`), so a pad lane costs a whole
    reconstruction here, where it was one lane of a vmap in the reference.
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
  * Bucket sizes are powers of two, capped by `max_batch` AND by the
    memory budget: the largest b with b * footprint(plan) <= hbm_bytes
    (planner/feasibility prices one scan's per-rank footprint; the batched
    engine replicates it per lane). Power-of-two buckets bound the number
    of distinct batch engines at log2(max_batch) per family.
  * A partial bucket is padded with zero scans; padding lanes are dropped
    from the output. The batched engine is bit-exact per lane
    (core/plan.py build_batched), so padding cannot perturb real scans.

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
                        on a condition variable, wakes on submit(), and
                        runs drain passes whenever work is queued — callers
                        never block, they `ticket.wait(timeout=)`. One
                        persistent SourcePrefetcher spans all passes
                        (extend() per pass — no thread churn), and a pass
                        that raises is counted and survived: the loop must
                        keep serving (graceful degradation).

I/O overlap: all admitted scans' projection loads run on a prefetch thread
(double-buffered — scan k+1 loads while scan k computes) and finished
volumes are written behind (AsyncWriteback) while the next bucket runs.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from concurrent.futures import Future

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

from .plan_cache import PlanCache
from .requests import (
    AdmissionError, QueueFullError, ScanFamily, ScanTicket, TicketState,
    _QueuedScan,
)

#: Cross-family bucket execution orders `ReconstructionService(policy=)`
#: accepts — see the module docstring for their semantics.
SCHEDULING_POLICIES = ("fifo", "largest_bucket", "deadline")


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _Bucket(NamedTuple):
    """One schedulable unit: same-family scans sharing a batched dispatch.
    `seq` is the bucket's earliest admission sequence number — the
    arrival-order key every policy tie-breaks on."""

    family: ScanFamily
    scans: List[_QueuedScan]
    bsz: int
    seq: int

    def deadline(self) -> float:
        """The bucket's most urgent ticket deadline (+inf when no lane
        carries an SLO) — the EDF sort key."""
        ds = [s.ticket.deadline for s in self.scans
              if s.ticket.deadline is not None]
        return min(ds) if ds else math.inf


class ReconstructionService:
    """Multi-scan reconstruction front end over one device fleet (mesh).

    mesh         : the fixed fleet every scan is served on (a DeviceMesh;
                   None = single device). Part of every scan family.
    device       : where every plan runs ("cuda" by default; on a mesh,
                   each rank's current device of that type).
    spec         : plan spec families resolve through ("auto" = planner
                   search, once per family — see PlanCache).
    max_batch    : bucket-size ceiling (power of two recommended).
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
        self._lock = threading.Lock()
        # Background-loop wakeup: submit()/shutdown() notify, the serve
        # thread waits. Shares self._lock so queue state and wakeup are
        # one atomic picture.
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
        for k in ("buckets", "padded_lanes", "prefetched_loads",
                  "writebacks"):
            self._c[k] = self.metrics.counter(f"service.{k}")
        self._c["slo_met"] = self.metrics.counter("service.slo.met")
        self._c["slo_missed"] = self.metrics.counter("service.slo.missed")
        self._c["loop_passes"] = self.metrics.counter("service.loop.passes")
        self._c["loop_errors"] = self.metrics.counter("service.loop.errors")
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
        budget — the reject half of admission; the queue bound is the
        backpressure half."""
        plan = self.plan_cache.resolve(family)
        if plan.schedule == "incremental":
            # build_batched would raise at drain time; reject NOW so a
            # bad pin never queues work the engine cannot serve.
            raise AdmissionError(
                "scan rejected: schedule='incremental' is stateful "
                "(projections arrive as deltas) and cannot be served by "
                "the batched engine — use plan.build_incremental() "
                "directly, or pin a batch schedule "
                "(fused/pipelined/chunked)")
        ok, reason = check_feasible(family.geometry, point_from_plan(plan),
                                    self.hbm_bytes, self.vmem_budget)
        if not ok:
            raise AdmissionError(
                f"scan rejected: plan [{plan.describe()}] does not fit the "
                f"budget ({self.hbm_bytes / 2**30:.2f} GiB HBM): {reason}")
        return plan

    def submit(self, projections=None, *, geometry: CBCTGeometry,
               source=None, sink=None, scan_id: Optional[str] = None,
               deadline_s: Optional[float] = None, **pins) -> ScanTicket:
        """Admit one scan. Exactly one of `projections` (in-memory
        (N_p, N_v, N_u) array) / `source` (ProjectionSource, loaded by the
        prefetch thread at drain time) carries the data; `sink`
        (VolumeSink) enables write-behind store of the result. `deadline_s`
        is the scan's time-to-volume SLO target (seconds from now; counted
        in `service.slo.met/missed` at completion, and the `deadline`
        policy schedules against it). `pins` are planner pins
        (precision=..., schedule=...) and widen the scan's family. Returns
        the scan's ticket; raises AdmissionError / QueueFullError instead
        of queueing work that cannot be served. Every rejection path counts
        in the `rejected` stat."""
        try:
            return self._submit(projections, geometry=geometry,
                                source=source, sink=sink, scan_id=scan_id,
                                deadline_s=deadline_s, pins=pins)
        except AdmissionError:     # includes QueueFullError
            self._c["rejected"].inc()
            raise

    def _check_queue_bound(self) -> None:
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"scan queue is full ({self.max_queue}); drain() or "
                "shed load")

    def _submit(self, projections, *, geometry: CBCTGeometry, source,
                sink, scan_id, deadline_s, pins) -> ScanTicket:
        if (projections is None) == (source is None):
            raise AdmissionError(
                "pass exactly one of projections= (in-memory scan) or "
                "source= (ProjectionSource to prefetch from)")
        if deadline_s is not None and deadline_s < 0:
            raise AdmissionError(
                f"deadline_s={deadline_s} must be >= 0 (seconds from "
                "submission)")
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
            ticket = ScanTicket(
                scan_id=scan_id or f"scan-{self._seq}", family=family,
                submitted_at=time.perf_counter(), deadline_s=deadline_s)
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

    # -- bucketing -----------------------------------------------------------

    def _bucket_capacity(self, family: ScanFamily, plan) -> int:
        """Largest power-of-two batch the budget admits for this family
        (>= 1: single-scan feasibility was checked at admission)."""
        fp = plan_footprint(family.geometry, point_from_plan(plan))
        per_scan = max(1, fp.total)
        cap = 1
        while (cap * 2 <= self.max_batch
               and (cap * 2) * per_scan <= self.hbm_bytes):
            cap *= 2
        return cap

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
                cap = self._bucket_capacity(fam, plan)
            except BaseException as e:
                for item in scans:
                    item.ticket._set_state(TicketState.FAILED, error=e)
                    self._observe_slo(item.ticket, t_done=None)
                    failed.append(item.ticket)
                self._c["failed"].inc(len(scans))
                continue
            for i in range(0, len(scans), cap):
                chunk = scans[i:i + cap]
                buckets.append(_Bucket(fam, chunk, _next_pow2(len(chunk)),
                                       chunk[0].seq))
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

    def _lane(self, item: _QueuedScan, data) -> torch.Tensor:
        """One scan's lane on the device: this rank's rows of an in-memory
        scan (all of it without a mesh), or a source's loaded rows."""
        if item.source is None and self.mesh is not None:
            data = local_projections(data, self.mesh)
        return torch.as_tensor(data, dtype=torch.float32, device=self.device)

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
        batched engine, hand sink-ed volumes to the write-behind pool.
        Never raises — a failure fails exactly this bucket's tickets."""
        fam, scans, bsz = bucket.family, bucket.scans, bucket.bsz
        bucket_span = tracer.span("service.bucket", batch=bsz,
                                  scans=len(scans))
        bucket_span.__enter__()
        t_bucket0 = time.perf_counter()
        tickets = [s.ticket for s in scans]
        for t in tickets:
            t._set_state(TicketState.BATCHED)
            if t.submitted_at is not None:
                self._h_queue_wait.observe(t_bucket0 - t.submitted_at)
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
                lanes.append(prefetch.get())
            except BaseException as e:
                lanes.append(None)
                if lane_err is None:
                    lane_err = e
        try:
            if lane_err is not None:
                raise lane_err
            plan = self.plan_cache.resolve(fam)
            engine = plan.build_batched(bsz)
            lanes = [self._lane(item, l) for item, l in zip(scans, lanes)]
            n_loads = sum(1 for s in scans if s.source is not None)
            n_pad = bsz - len(lanes)
            if n_pad:
                lanes.extend([torch.zeros_like(lanes[0])] * n_pad)
            batch = torch.stack(lanes)
            del lanes
            asm_span.__exit__(None, None, None)
            asm_span = None
            self._h_assembly.observe(time.perf_counter() - t_bucket0)
            for t in tickets:
                t._set_state(TicketState.SERVING)
            out = engine(batch)
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
                if item.ticket.submitted_at is not None:
                    self._h_ttv.observe(t_done - item.ticket.submitted_at)
                self._observe_slo(item.ticket, t_done)
                if item.sink is not None:
                    writes.append((item.ticket,
                                   self._store(item, vol, layout, spec)))
            self._c["buckets"].inc()
            self._c["padded_lanes"].inc(n_pad)
            self._c["prefetched_loads"].inc(n_loads)
            self._c["served"].inc(len(scans))
            self._c["writebacks"].inc(
                sum(1 for s in scans if s.sink is not None))
        except BaseException as e:
            for item in scans:
                item.ticket._set_state(TicketState.FAILED, error=e)
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
        buckets, served = self._make_buckets()
        if not buckets:
            return served
        jobs = self._load_jobs(buckets)
        own_prefetch = prefetch is None
        if own_prefetch:
            prefetch = SourcePrefetcher(jobs,
                                        depth=self.prefetch_depth).start()
        else:
            prefetch.extend(jobs)
        tracer = get_tracer()
        writes: List[Tuple[ScanTicket, object]] = []
        drain_span = tracer.span("service.drain", n_buckets=len(buckets))
        drain_span.__enter__()
        try:
            for bucket in buckets:
                served.extend(self._serve_bucket(bucket, prefetch, writes,
                                                 tracer))
        finally:
            if own_prefetch:
                prefetch.close()
            drain_span.__exit__(None, None, None)
        self._join_writes(writes)
        return served

    def drain(self) -> List[ScanTicket]:
        """Serve every queued scan on the CALLER's thread: bucket by
        family, order buckets by the scheduling policy, reconstruct each
        bucket in one batched dispatch, store sink-ed results write-behind.
        Returns the tickets served this drain in execution order (DONE or
        FAILED — a failed bucket fails only its own tickets). Mutually
        exclusive with the background loop (shutdown() first)."""
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
        take the whole service down with scans still arriving)."""
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        prefetch = SourcePrefetcher(depth=self.prefetch_depth,
                                    persistent=True).start()
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._shutdown_requested:
                        # The timeout is a lost-wakeup safety net; normal
                        # wakeup is submit()/shutdown() notifying.
                        self._cv.wait(timeout=0.1)
                    if not self._queue and self._shutdown_requested:
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
        `engine_cache` covers the batched engines (core/plan.py's
        engine cache). `latency` holds
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
            "padded_lanes": v("service.padded_lanes", 0),
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
        counters["latency"] = {
            "queue_wait": self._h_queue_wait.snapshot(),
            "bucket_assembly": self._h_assembly.snapshot(),
            "time_to_volume": self._h_ttv.snapshot(),
        }
        counters["plan_cache"] = self.plan_cache.stats()
        counters["engine_cache"] = engine_cache_stats()
        return counters

    def close(self) -> None:
        """Shut the background loop down (serving queued work first) and
        join the write-behind pool."""
        if self.serving:
            self.shutdown()
        self._writeback.close()
