"""One run of one cell: set-up, the measured window, the check.

Set-up makes the pool's scans from the seed on the run's device (copied
down to pageable host memory once, where the mix places scans on the
host), starts the program's `ReconstructionService` with the
configuration's concrete plan spec, and warms every shape the window will
use. The window is driven by the mix's traffic loop
(bench/traffic/loops/<loop>.py), which submits scans with
`ReconstructionService.submit(projections=..., geometry=...)` through the
service's background loop and waits on `ScanTicket.wait()`; the client
keeps each volume's sampled voxels (bench/harness/client.py). A scan is
timed from when it was due (a closed loop: its submit; an open loop: its
scheduled arrival) to when the client saw its volume; scans still out
when the window closes are waited for, up to GRACE_S.

With `trace`, the window runs under `torch.profiler` and the program's
span tracer; after it, the per-layer readers of the cell read the
reduced trace and the service's counters (`TraceContext`).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from bench.harness import check, client as clients, profile, stats, traffic
from bench.harness.registry import Registry
from bench.reference import fdk
from bench.reference.geometry import Geometry

GRACE_S = 60.0
WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "fp16": 2, "fp8_e4m3": 1,
                 "fp8_e5m2": 1}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def spec_fields(spec: str) -> Dict[str, str]:
    return dict(item.split("=", 1) for item in spec.split(",") if item)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader (bench/metrics/<name>.py, `read(ctx)`) may
    read. Device times are the traced window's; `scans` is the number of
    scans whose work the window holds (all of it: the trace stops once
    every scan due has landed)."""

    registry: Registry
    geometry: Geometry
    config: dict
    device: torch.device
    device_kind: str
    scans: int
    window_s: float
    busy_s: float
    ops: List[profile.DeviceOp]
    service: Dict[str, float]

    @property
    def peak(self) -> Optional[dict]:
        return self.registry.peaks(self.device_kind)

    @property
    def wire_itemsize(self) -> int:
        return WIRE_ITEMSIZE[spec_fields(self.config["plan"])["precision"]]

    def kernel_seconds(self, family: str) -> float:
        names = self.registry.kernel_names(family)
        return sum(o.dur_us for o in self.ops
                   if o.cat == "kernel" and any(n in o.name for n in names)
                   ) / 1e6

    def device_seconds(self, cat: Optional[str] = None,
                       contains: str = "") -> float:
        return sum(o.dur_us for o in self.ops
                   if (cat is None or o.cat == cat) and contains in o.name
                   ) / 1e6


def _service_numbers(svc) -> Dict[str, float]:
    m = svc.metrics
    asm = m.get("service.bucket_assembly_seconds")
    return {"assembly_seconds": asm.sum, "buckets_assembled": asm.count,
            "padded_lanes": m.value("service.padded_lanes", 0),
            "served": m.value("service.scans.served", 0)}


def run(reg: Registry, cell: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_process: Optional[float] = None,
        spec: Optional[str] = None, mix_overrides: Optional[dict] = None,
        log_fn: Callable[[str], None] = log) -> dict:
    """One run of `cell`; returns the result object (without `device`'s
    platform fields, which the caller adds) and, under `timeline`, each
    scan's (due, time to volume) in seconds from the window's start.
    `spec` replaces the configuration's plan spec (the control's lower
    precision); `mix_overrides` replaces fields of the traffic mix (the
    rate sweep)."""
    from repro_torch.core.plan import clear_engine_cache
    from repro_torch.obs import trace as program_trace
    from repro_torch.service import ReconstructionService
    from repro_torch.service.requests import AdmissionError

    t_process = time.perf_counter() if t_process is None else t_process
    wl = reg.cell(cell)
    cfg = reg.config(wl["config"])
    mix = traffic.validate(dict(reg.traffic(wl["traffic"]),
                                **(mix_overrides or {})), reg.loops())
    loop = reg.loop(mix["loop"])
    dev = torch.device(device)
    g = Geometry.from_dict(cfg["geometry"])

    def stamp(what):
        log_fn(f"set-up {time.perf_counter() - t_process:8.3f} s: {what}")

    stamp("program imported")
    pool = getattr(loop, "make_pool", clients.default_pool)(
        cfg, seed, mix, dev)
    stamp(f"{len(pool)} scans made ({mix['placement']})")
    svc = ReconstructionService(device=str(dev), spec=spec or cfg["plan"],
                                **cfg["service"])
    client = clients.Client(svc, pool, seed, dev, AdmissionError)
    getattr(loop, "warm", clients.warm_buckets)(client, mix, stamp)

    prof = tracer = None
    if trace:
        tracer = program_trace.get_tracer()
        tracer.enabled = True
        tracer.clear()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    before = _service_numbers(svc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mark_ns = time.perf_counter_ns()
    if trace:
        tracer.instant(profile.MARKER)
        marker = torch.profiler.record_function(profile.MARKER)
        marker.__enter__()
    t_start = mark_ns / 1e9
    setup_s = t_start - t_process
    client.give_up = t_start + seconds + GRACE_S
    scans = loop.drive(client, mix, t_start, seconds, seed)
    t_end = t_start + seconds
    if trace:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marker.__exit__(None, None, None)
        t_traced = time.perf_counter()
        prof.__exit__(None, None, None)
        tracer.enabled = False
    after = _service_numbers(svc)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    client_spans = client.spans
    svc.close()
    del svc, client
    clear_engine_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    landed = [s for s in scans if s.seen is not None]
    late = [s.late for s in scans]
    lateness = None
    if any(late):
        lateness = (f"generator lateness over {len(late)} arrivals: mean "
                    f"{1e3 * sum(late) / len(late):.3f} ms, p99 "
                    f"{1e3 * stats.percentile(late, 99):.3f} ms, max "
                    f"{1e3 * max(late):.3f} ms")
    served = {k: after[k] - before[k] for k in after}
    log_fn(f"service in the window: {served['buckets_assembled']:g} "
           f"buckets, {served['served']:g} scans and "
           f"{served['padded_lanes']:g} pad lanes served, assembly "
           f"{served['assembly_seconds']:.6f} s")
    inside = [s for s in landed if s.seen <= t_end]
    window = {
        "ttv": [(s.seen if s.seen is not None else t_end + GRACE_S) - s.due
                for s in scans],
        "landed": len(inside),
        "last_landed_s": max((s.seen for s in inside), default=t_start)
        - t_start,
        "updates": sum(float(pool[s.pool].geometry.n_voxels)
                       * pool[s.pool].geometry.n_proj for s in inside),
        "setup_s": setup_s,
    }
    result = {"attempted": len(scans), "lateness": lateness,
              "failed": len(scans) - len(landed),
              "timeline": [(s.due - t_start, ttv)
                           for s, ttv in zip(scans, window["ttv"])]}
    if trace:
        ctx, breakdown = _trace_context(
            reg, cfg, g, dev, prof, tracer, client_spans, scans=len(landed),
            mark_ns=mark_ns, t_traced=t_traced, service=served)
        metrics = {}
        for m in reg.per_layer(cell):
            value = reg.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(busy_s=ctx.busy_s, window_s=ctx.window_s,
                      breakdown=breakdown)
        del ctx
    else:
        metrics = {m["name"]: {"value": stats.end_to_end(m["name"], window),
                               "unit": m["unit"]}
                   for m in reg.end_to_end(cell)}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = peak

    kept = [(s.pool, s.kept) for s in landed]
    for s in scans:
        s.kept = None
    refs = {}
    for p in sorted({s.pool for s in landed}):
        ps = pool[p]
        proj = ps.projections.to(dev)
        refs[p] = fdk.reconstruct_at(
            ps.geometry, proj,
            check.sample_indices(ps.geometry.n_voxels, seed, dev))
        del proj
    numbers = check.gaps(kept, refs)
    numbers["missing"] = result["failed"]
    ok, checks = check.verdict(numbers, dict(cfg["limits"], missing=0))
    result["correct"] = ok and len(landed) > 0
    result["checks"] = checks
    errors = sorted({s.error for s in scans if s.error})
    if errors:
        log_fn(f"{len(errors)} kinds of failure, first: {errors[0]}")
    return result


def _trace_context(reg, cfg, g, dev, prof, tracer, client_spans, scans,
                   mark_ns, t_traced, service):
    """(TraceContext, breakdown) of the traced window."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        ops, marker_us = profile.read_trace(path)
    t0 = marker_us if marker_us is not None else (
        ops[0].start_us if ops else 0.0)
    t1 = t0 + (t_traced * 1e9 - mark_ns) / 1e3
    busy = profile.busy_intervals(ops, t0, t1)
    busy_s = sum(e - s for s, e in busy) / 1e6
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    ctx = TraceContext(registry=reg, geometry=g, config=cfg, device=dev,
                       device_kind=kind, scans=scans,
                       window_s=(t1 - t0) / 1e6, busy_s=busy_s, ops=ops,
                       service=service)
    # host spans on the profiler's clock, for the idle gaps' labels: the
    # program's own first, then the client's around its calls
    events = tracer.events()
    epoch_ns = mark_ns - next(e["ts"] for e in events
                              if e["name"] == profile.MARKER) * 1e3

    def on_profiler_clock(spans):
        return [profile.HostSpan(name, t0 + (a - mark_ns) / 1e3,
                                 t0 + (b - mark_ns) / 1e3)
                for name, a, b in spans]

    program_spans = on_profiler_clock(
        (e["name"], epoch_ns + e["ts"] * 1e3,
         epoch_ns + (e["ts"] + e["dur"]) * 1e3)
        for e in events if e["ph"] == "X")
    gaps = profile.label_gaps(profile.idle_gaps(busy, t0, t1),
                              program_spans, on_profiler_clock(client_spans))
    breakdown = {
        "device_ops": profile.top_ops(ops),
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }
    return ctx, breakdown
