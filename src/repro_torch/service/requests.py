"""Scan requests, families, and tickets — the service's data model.

Port of `repro/service/requests.py`.

A **family** is the bucketing identity: two requests may share one batched
engine dispatch iff their (geometry, mesh, plan pins) triples are equal —
that triple determines the plan the planner would pick, the engine trace,
and every array shape in the pipeline. It is also the plan-cache key
(plan_cache.py), so "same family" and "planner search already paid" are
the same statement.

A **ticket** is the caller's handle on one submitted scan: its lifecycle
(QUEUED -> BATCHED -> SERVING -> DONE | FAILED; REJECTED never enters the
queue), the reconstructed volume once served, and the error if its bucket
failed. With the background drain loop (scheduler.serve()) tickets are
served on another thread, so every state transition goes through
`_set_state` (one lock per ticket, terminal states sticky against
non-terminal writes) and terminal transitions fire a per-ticket
`threading.Event` that `wait(timeout=)` callers block on.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional

from ..core.geometry import CBCTGeometry


class AdmissionError(ValueError):
    """The request was REJECTED at submit time — footprint over the memory
    budget (planner/feasibility said no plan point fits) or malformed. The
    scan never enters the queue; nothing was partially served."""


class QueueFullError(AdmissionError):
    """Backpressure: the scan queue is at max_queue. Callers should retry
    after a drain (or shed load) — queueing unboundedly would just move the
    OOM from device memory to host memory."""


@dataclasses.dataclass(frozen=True)
class ScanFamily:
    """The bucketing identity + plan-cache key: (geometry, mesh, pins).

    `pins` is the canonicalized (sorted key/value tuple) form of the
    caller's planner pins (e.g. precision="bf16") — part of the identity
    because pinned requests must not share a plan (or a bucket) with
    unpinned ones.
    """

    geometry: CBCTGeometry
    mesh: Optional[object]          # a DeviceMesh (hashable) or None
    pins: tuple = ()

    @staticmethod
    def make(geometry: CBCTGeometry, mesh, pins: dict) -> "ScanFamily":
        return ScanFamily(geometry=geometry, mesh=mesh,
                          pins=tuple(sorted((pins or {}).items())))

    def pins_dict(self) -> dict:
        return dict(self.pins)


class TicketState(enum.Enum):
    QUEUED = "queued"       # admitted, waiting for a drain
    BATCHED = "batched"     # assigned to a bucket this drain pass
    SERVING = "serving"     # its bucket's batched dispatch is in flight
    DONE = "done"           # volume ready (and stored, if a sink was given)
    FAILED = "failed"       # its bucket's dispatch or store raised


#: Terminal states — once reached, only terminal->terminal transitions are
#: allowed (a write-behind store failure flips DONE -> FAILED; nothing can
#: resurrect a finished ticket back into the queue's states).
TERMINAL_STATES = frozenset({TicketState.DONE, TicketState.FAILED})


@dataclasses.dataclass
class ScanTicket:
    """One submitted scan's handle. `volume` is the engine's per-scan
    output (on a mesh, this rank's part, in the single-scan engine's
    layout); `error` holds the
    exception when state is FAILED.

    Tickets served by the background loop finish on another thread:
    `wait(timeout=)` blocks until the ticket is terminal (DONE or FAILED —
    the loop fires `_done_event` exactly at that transition), and
    `deadline_s` is the caller's time-to-volume SLO target, measured from
    `submitted_at` (the scheduler counts `service.slo.met/missed` against
    the absolute `deadline` at completion time).
    """

    scan_id: str
    family: ScanFamily
    state: TicketState = TicketState.QUEUED
    volume: Optional[object] = None
    error: Optional[BaseException] = None
    # Monotonic submit timestamp (time.perf_counter()), stamped by the
    # scheduler at admission — the zero point for the queue-wait and
    # time-to-volume latency histograms. None for hand-built tickets.
    submitted_at: Optional[float] = None
    # Time-to-volume SLO target in seconds from submit (None = no SLO).
    deadline_s: Optional[float] = None
    _done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    _state_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def deadline(self) -> Optional[float]:
        """Absolute SLO deadline on the `time.perf_counter()` clock, or
        None when the scan has no SLO (or no submit timestamp)."""
        if self.deadline_s is None or self.submitted_at is None:
            return None
        return self.submitted_at + self.deadline_s

    @property
    def done(self) -> bool:
        return self.state is TicketState.DONE

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket is terminal (DONE or FAILED); returns
        True when it is, False on timeout. The call that makes the
        background loop usable: submit -> wait -> result."""
        return self._done_event.wait(timeout)

    def _set_state(self, state: TicketState, *, volume=None,
                   error: Optional[BaseException] = None) -> bool:
        """Thread-safe transition (scheduler-internal). Terminal states are
        sticky: once DONE/FAILED, only another terminal state may overwrite
        (the write-behind store-failure flip DONE -> FAILED). Returns
        whether the transition was applied; fires the done event on
        reaching a terminal state."""
        with self._state_lock:
            if self.state in TERMINAL_STATES and state not in TERMINAL_STATES:
                return False
            if volume is not None:
                self.volume = volume
            if error is not None:
                self.error = error
            self.state = state
        if state in TERMINAL_STATES:
            self._done_event.set()
        return True

    def result(self, timeout: Optional[float] = None):
        """The reconstructed volume; raises the bucket's error for FAILED
        tickets and RuntimeError when the scan has not been served yet.
        `timeout` waits for a terminal state first (background-loop
        callers); the default stays non-blocking for the synchronous
        drain() flow."""
        if timeout is not None:
            self.wait(timeout)
        if self.state is TicketState.FAILED:
            raise RuntimeError(
                f"scan {self.scan_id!r} failed to reconstruct"
            ) from self.error
        if self.state is not TicketState.DONE:
            raise RuntimeError(
                f"scan {self.scan_id!r} is {self.state.value}; call "
                "ReconstructionService.drain() (or serve() the background "
                "loop and ticket.wait()) to serve queued scans")
        return self.volume


@dataclasses.dataclass
class _QueuedScan:
    """Internal queue entry: the ticket plus how to obtain its projections
    (exactly one of `projections` / `source` is set), where to store the
    result (optional sink), and the admission sequence number `seq` — the
    arrival-order key the scheduling policies tie-break on."""

    ticket: ScanTicket
    projections: Optional[object] = None
    source: Optional[object] = None          # io.streams.ProjectionSource
    sink: Optional[object] = None            # io.streams.VolumeSink
    seq: int = 0
