"""Span tracer: nested monotonic-clock timing with dispatch/compute fencing.

Port of `repro/obs/trace.py`: explicitly instrumented SPANS (named, nested,
monotonic-clock intervals) collected by a thread-safe `Tracer` and exported
as Chrome/Perfetto ``trace_event`` JSON (`chrome://tracing` and
ui.perfetto.dev load it directly).

Asynchronous launches: a CUDA kernel launch returns as soon as the work is
queued on the stream, so the wall time of the Python call is dispatch, not
compute. A span that should attribute device time must FENCE:
``span.fence(out)`` records the elapsed time at the fence point as the
span's ``dispatch_us`` attribute, then waits until every CUDA tensor in
``out`` is computed (a CUDA event recorded on each tensor's device's
current stream, then synchronised), so the span's total duration is
dispatch + compute. CPU tensors need no wait. Spans without a fence
measure host time only (I/O, queue waits).

Overhead contract: with the tracer DISABLED (the default), ``span()``
returns a preallocated no-op context manager — no clock read, no
allocation, no lock — so instrumented hot paths cost one attribute load and
one branch per span. ``span(..., timed=True)`` always measures (its
duration is readable from the returned span) but still records an event
only when enabled.

Usage::

    from repro_torch import obs
    obs.enable()                      # or Tracer(enabled=True) locally
    with obs.span("engine.fused", schedule="fused") as sp:
        out = fdk(projections)
        sp.fence(out)                 # dispatch recorded, wait for the card
    obs.get_tracer().save("trace.json")

Span names are dotted ``subsystem.event`` (e.g. ``engine.reconstruct``,
``stage.read``, ``session.fold``, ``io.prefetch.load``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "enable", "disable",
    "span", "wait_for",
]

# Cap on buffered events per tracer: a forgotten always-on tracer in a
# long-lived service must not grow without bound. Overflow drops new spans
# (counted in `dropped`) instead of evicting old ones — the trace's
# beginning is usually the interesting part of a runaway.
MAX_EVENTS = 200_000


def _cuda_devices(value: Any, out: set) -> set:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def wait_for(value: Any) -> None:
    """Block until every CUDA tensor in `value` is computed: one event per
    device, recorded on its current stream (where the engine queued the
    work) and synchronised. CPU tensors and other leaves cost nothing."""
    for dev in _cuda_devices(value, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _NullSpan:
    """The disabled-path span: every method is a no-op. One shared instance;
    it holds no state, so reuse across threads/nestings is safe."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def fence(self, value: Any) -> Any:
        return value

    def set(self, **attrs: Any) -> None:
        return None

    @property
    def duration_s(self) -> float:
        return 0.0


_NULL_SPAN = _NullSpan()


class Span:
    """One named interval. Created by `Tracer.span` (context manager);
    closed on context exit, after which `duration_s` / `dispatch_s` are
    readable. Not reentrant — each `with` gets a fresh Span."""

    __slots__ = ("name", "args", "_tracer", "_record", "_t0", "_t1",
                 "_fence_ns", "_tid")

    def __init__(self, tracer: "Tracer", name: str, record: bool,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.args = args or {}
        self._tracer = tracer
        self._record = record
        self._t0 = 0
        self._t1 = 0
        self._fence_ns: Optional[int] = None
        self._tid = 0

    def __enter__(self) -> "Span":
        self._tid = threading.get_ident()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._t1 = time.perf_counter_ns()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        if self._record:
            self._tracer._finish(self)

    def set(self, **attrs: Any) -> None:
        """Attach attributes (rendered as Perfetto ``args``)."""
        self.args.update(attrs)

    def fence(self, value: Any) -> Any:
        """Record the dispatch-to-here elapsed time, then wait until every
        CUDA tensor in `value` (a tensor, or tuples, lists and dicts of
        them; None and other leaves are skipped) is computed. The span's
        remaining time is device compute the dispatch did not wait for."""
        self._fence_ns = time.perf_counter_ns() - self._t0
        wait_for(value)
        return value

    # -- readable after close ------------------------------------------------

    @property
    def duration_s(self) -> float:
        return (self._t1 - self._t0) / 1e9

    @property
    def dispatch_s(self) -> Optional[float]:
        """Elapsed at the fence point (None when the span never fenced)."""
        return None if self._fence_ns is None else self._fence_ns / 1e9


class Tracer:
    """Thread-safe span collector with Perfetto ``trace_event`` export.

    Spans nest per thread by construction — a ``ph: "X"`` (complete) event
    whose [ts, ts+dur) interval contains another on the same tid renders as
    its parent — so no explicit parent bookkeeping is needed; the
    monotonic timestamps do the nesting.
    """

    def __init__(self, enabled: bool = False, max_events: int = MAX_EVENTS):
        self.enabled = enabled
        self.max_events = max_events
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        # One epoch per tracer: Perfetto ts values are microseconds relative
        # to it, so traces start near t=0 instead of at machine uptime.
        self._epoch_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, timed: bool = False, **attrs: Any):
        """Context manager timing one interval.

        Disabled tracer: returns the shared no-op span (zero cost) unless
        `timed=True`, which measures anyway — the span's `duration_s` is
        readable afterward — but records no event.
        """
        if not self.enabled:
            if not timed:
                return _NULL_SPAN
            return Span(self, name, record=False, args=attrs or None)
        return Span(self, name, record=True, args=attrs or None)

    def _finish(self, sp: Span) -> None:
        ev = {
            "ph": "X",
            "name": sp.name,
            "ts": (sp._t0 - self._epoch_ns) / 1e3,   # µs, tracer-relative
            "dur": (sp._t1 - sp._t0) / 1e3,
            "pid": os.getpid(),
            "tid": sp._tid,
        }
        args = dict(sp.args)
        if sp._fence_ns is not None:
            args["dispatch_us"] = sp._fence_ns / 1e3
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def instant(self, name: str, **attrs: Any) -> None:
        """Zero-duration marker event (``ph: "i"``)."""
        if not self.enabled:
            return
        ev = {
            "ph": "i", "name": name, "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = attrs
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- consumption ---------------------------------------------------------

    def events(self) -> List[dict]:
        """Copy of the buffered trace events (Perfetto dict form)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def spans(self, prefix: str = "") -> List[dict]:
        """Finished complete-spans (``ph == "X"``), optionally filtered by
        name prefix.
        Durations are in MICROseconds (`dur`), like the wire format."""
        with self._lock:
            return [dict(e) for e in self._events
                    if e["ph"] == "X" and e["name"].startswith(prefix)]

    def stage_totals(self, prefix: str = "stage.") -> Dict[str, float]:
        """Summed SECONDS per span name under `prefix` — the per-stage
        aggregate."""
        totals: Dict[str, float] = {}
        for e in self.spans(prefix):
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] / 1e6
        return totals

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch_ns = time.perf_counter_ns()

    # -- export --------------------------------------------------------------

    def export(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped": self.dropped},
        }

    def save(self, path: str) -> str:
        """Write the trace JSON; returns `path`."""
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# Process-default tracer: instrumented library code traces through this so
# one `obs.enable()` lights every subsystem up at once. Disabled by
# default — the no-op span path is the production cost.
# ---------------------------------------------------------------------------

_DEFAULT = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _DEFAULT


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer (tests install a fresh one);
    returns the previous tracer."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tracer
    return prev


def enable() -> Tracer:
    _DEFAULT.enabled = True
    return _DEFAULT


def disable() -> Tracer:
    _DEFAULT.enabled = False
    return _DEFAULT


def span(name: str, timed: bool = False, **attrs: Any):
    """`get_tracer().span(...)` — the one-liner instrumentation points use."""
    return _DEFAULT.span(name, timed=timed, **attrs)
