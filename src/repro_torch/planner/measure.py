"""Measured refinement: time the top-k proposals' built engines.

Port of `repro/planner/measure.py`: the engine runs on the plan's device,
synchronized, inside a `timed=True` span; the key names the device type,
the card and the device count where the reference names its backend.

The cost model ranks the whole space; this closes the loop on the few
survivors the way the autotuner does for kernel tiles — build each
mesh-backed proposal, run it on synthetic projections of the true shape,
and re-rank by wall clock. Timings are memoized in-process and in a
file-backed JSON cache so a planning session pays for each (geometry,
engine, backend) once across processes.

Knobs:
  REPRO_PLAN_CACHE   path of the measurement cache (JSON). Default
                     ~/.cache/repro/plan_measure_cache.json; "off"/"0"/""
                     disables persistence (same convention as
                     REPRO_TUNE_CACHE — shared machinery,
                     repro_torch/filecache.py).
"""
from __future__ import annotations

import json
from typing import Dict, List

import torch

from ..core.geometry import CBCTGeometry
from ..device import resolve_device
from ..filecache import JsonFileCache
from ..obs.trace import get_tracer, wait_for

from .search import PlanProposal

_CACHE: Dict[tuple, float] = {}
_FILE_CACHE = JsonFileCache("REPRO_PLAN_CACHE", "plan_measure_cache.json")


def clear_cache() -> None:
    """Drop the in-process memo (the file cache, if any, is untouched)."""
    _CACHE.clear()


def file_cache_hits() -> int:
    """How many timings this process served from the file cache."""
    return _FILE_CACHE.hits


def cache_path():
    """Resolved file-cache path, or None when persistence is disabled."""
    return _FILE_CACHE.path()


def _measure_key(g: CBCTGeometry, proposal: PlanProposal,
                 iters: int) -> tuple:
    # plan.describe() is the full engine identity (schedule/impl/precision/
    # grid/steps/chunks/reduce/window AND the resolved kernel blocks — two
    # vmem budgets that tune to different tiles get different keys); the
    # data-axis extent disambiguates meshes that share an (R, C) grid but
    # split C differently between pod and data (different scatter layout).
    plan = proposal.plan
    desc = json.dumps(plan.describe(), sort_keys=True, default=list)
    dev = resolve_device(plan.device)
    if dev.type == "cuda":
        card, count = torch.cuda.get_device_name(dev), \
            torch.cuda.device_count()
    else:
        card, count = dev.type, 1
    return (g.n_proj, g.n_u, g.n_v, g.n_x, g.n_y, g.n_z, desc,
            plan._data_size, dev.type, card, count, iters)


def measure_proposal(g: CBCTGeometry, proposal: PlanProposal,
                     iters: int = 2) -> float:
    """Seconds per reconstruction of the proposal's built engine on
    synthetic projections (zeros: the work depends on the geometry, not on
    the projection values). Requires a mesh-backed proposal (`plan` set);
    on a mesh every rank calls it with the same proposal."""
    if proposal.plan is None:
        raise ValueError(
            "cannot measure a grid-only proposal (no mesh to build on); "
            "use search_plans / auto_plan for measured refinement")
    key = _measure_key(g, proposal, iters)
    hit = _CACHE.get(key)
    if hit is None:
        entry = _FILE_CACHE.get(key)
        if isinstance(entry, (int, float)):
            _FILE_CACHE.hits += 1
            hit = _CACHE[key] = float(entry)
    if hit is not None:
        return hit

    plan = proposal.plan
    fn = plan.build()
    shape = g.proj_shape()
    if plan.mesh is not None:
        shape = (g.n_proj // plan.grid.n_ranks,) + shape[1:]
    proj = torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(plan.device))
    wait_for(fn(proj))  # build + warm up
    # timed=True: the span measures even with tracing disabled (this IS the
    # measurement); with tracing enabled the refinement runs also land in
    # the exported trace, attributable per proposal via the spec attr.
    with get_tracer().span("planner.measure", timed=True, iters=iters,
                           spec=plan.describe().get("schedule")) as sp:
        for _ in range(iters):
            out = fn(proj)
        sp.fence(out)
    seconds = sp.duration_s / iters
    _CACHE[key] = seconds
    _FILE_CACHE.put(key, seconds)
    # One measurement path, two consumers: the same timing that re-ranks
    # this search also feeds the calibration store (planner/calibrate.py),
    # so refinement runs accumulate into the fitted overlay instead of
    # being discarded after ranking. Cached hits above do NOT re-record —
    # each wall-clock measurement is one sample.
    from .calibrate import record_engine_measurement
    record_engine_measurement(g, proposal.point, seconds)
    return seconds


def refine(g: CBCTGeometry, proposals: List[PlanProposal],
           top_k: int = 3, iters: int = 2) -> List[PlanProposal]:
    """Re-rank the first `top_k` proposals by measured seconds/call; the
    unmeasured tail keeps its model order behind them."""
    import dataclasses

    head = [
        dataclasses.replace(p, measured=measure_proposal(g, p, iters))
        for p in proposals[:top_k]
    ]
    head.sort(key=lambda p: p.measured)
    return head + list(proposals[top_k:])
