"""Reduces a traced window to what the per-layer readers and the breakdown
need: the device's operations, its busy time, and its idle gaps labelled
by what the host was doing.

The window is traced by `torch.profiler` (CUPTI on the card) and exported
as a Chrome trace: device operations are the events of category `kernel`,
`gpu_memcpy` and `gpu_memset`, in microseconds on the profiler's clock.
Host spans (the program's own tracer, and the benchmark's around its
calls into the program) are on `time.perf_counter_ns`; one marker, a
`record_function` entered at a known perf_counter instant, maps them onto
the profiler's clock.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "bench.window"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    cat: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass(frozen=True)
class HostSpan:
    name: str
    start_us: float     # on the profiler's clock
    end_us: float


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:          # drop the parenthesised argument list
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and out and out[-1] != " ":
            break
        out.append(ch)
    return "".join(out).strip()[:120]


def read_trace(path: str) -> Tuple[List[DeviceOp], Optional[float]]:
    """(device operations, the marker's start) from a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, marker = [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(e["name"], cat, float(e["ts"]),
                                float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e.get("name") == MARKER:
            marker = float(e["ts"])
    ops.sort(key=lambda o: o.start_us)
    return ops, marker


def busy_intervals(ops: Sequence[DeviceOp], t0: float, t1: float
                   ) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, clipped to [t0, t1]."""
    out: List[Tuple[float, float]] = []
    for o in ops:
        s, e = max(o.start_us, t0), min(o.end_us, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_gaps(busy: Sequence[Tuple[float, float]], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def label_gaps(gaps: Sequence[Tuple[float, float]],
               *span_sets: Sequence[HostSpan]) -> Dict[str, float]:
    """Idle seconds by the innermost host span open at each gap's middle,
    taken from the first of `span_sets` that has one ("no span" where
    none has)."""
    sets = []
    for spans in span_sets:
        start = np.array([h.start_us for h in spans], dtype=np.float64)
        end = np.array([h.end_us for h in spans], dtype=np.float64)
        sets.append((start, end, end - start, [h.name for h in spans]))
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2.0
        key = "no span"
        for start, end, length, names in sets:
            open_ = np.flatnonzero((start <= mid) & (mid < end))
            if open_.size:
                key = names[open_[np.argmin(length[open_])]]
                break
        out[key] = out.get(key, 0.0) + (e - s) / 1e6
    return out


def top_ops(ops: Sequence[DeviceOp], n: int = 10) -> List[list]:
    """[[short name, seconds], ...] of the n operations taking most time."""
    tot: Dict[str, float] = {}
    for o in ops:
        k = short_name(o.name)
        tot[k] = tot.get(k, 0.0) + o.dur_us / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
