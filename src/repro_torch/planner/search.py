"""Plan search: enumerate, prune, rank — return top-k PlanProposals.

Port of `repro/planner/search.py`, over the port's `DeviceMesh` and with
the plans' `device`: on a CUDA device both deployment impls
("factorized", "kernel") compete, where the reference tests for a TPU.

The search space is the cross-product the plan layer exposes:

  grid       R x C factorizations (core/distributed.grid_candidates) when
             searching over a device count; fixed by the mesh otherwise.
  schedule   fused | pipelined | chunked (+ n_steps, y_chunks candidates).
             The streaming "incremental" schedule is priced and rankable
             but only enumerated when PINNED (schedule="incremental"):
             its plans build stateful sessions (`build_incremental()`),
             not batch callables, so the default search must never hand
             one to a caller expecting `plan.build()` — and its figure of
             merit is latency (cost.time_from_last_delta), which the
             throughput ranking below does not capture.
  reduce     psum | scatter | scatter_bf16 (half-width compensated scatter)
  precision  fp32 | bf16 | fp16 | fp8_e4m3 | fp8_e5m2 (quarter-width +
             scale sidecar; e5m2 trades one mantissa bit for range)
  impl       factorized | kernel (| reference)

Candidates that violate the pipeline's divisibility rules are skipped (for
mesh-backed searches `ReconstructionPlan.validate()` is the authority);
survivors are priced by the plan-aware cost model (cost.py), pruned by the
per-device memory model (feasibility.py), and ranked by modeled runtime
quantized to ~1% buckets (the model's resolution — see
`_quantized_predicted`). Ties (the overlap model is a max — plans off the
bottleneck cost the same — and anything within a percent counts as tied)
break toward accuracy and simplicity: wider storage first, then
fused < pipelined < chunked, fewer micro-batches, psum before scatter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

from ..core.distributed import IFDKGrid, SCATTER_REDUCES, grid_candidates
from ..core.geometry import CBCTGeometry
from ..core.perf_model import (
    ABCI, MachineSpec, PerfBreakdown, gups_end_to_end,
)
from ..core.precision import resolve_precision
from ..device import resolve_device

from .cost import PlanPoint, predict_point
from .feasibility import DEFAULT_HBM_BYTES, MemoryFootprint, check_feasible, \
    plan_footprint

_SCHEDULE_ORDER = ("fused", "pipelined", "chunked")
# Ranking knows every schedule, including the pin-only streaming one.
_RANK_SCHEDULE_ORDER = _SCHEDULE_ORDER + ("incremental",)
_REDUCE_ORDER = ("psum", "scatter", "scatter_bf16")
# Tie-break order within equal wire width: e4m3 before e5m2 (one extra
# mantissa bit ~= 6 dB PSNR at the same bytes; e5m2 wins only when pinned
# for its exponent range).
_PRECISION_ORDER = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")

DEFAULT_N_STEPS = (1, 2, 4, 8)
DEFAULT_Y_CHUNKS = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class PlanProposal:
    """One ranked search result: the plan point, its modeled cost and
    footprint, and — when the search had a mesh — a buildable plan."""

    point: PlanPoint
    breakdown: PerfBreakdown
    footprint: MemoryFootprint
    feasible: bool
    reason: str = ""
    plan: Optional[object] = None       # ReconstructionPlan when mesh-backed
    measured: Optional[float] = None    # seconds/call (planner/measure.py)

    @property
    def predicted(self) -> float:
        return self.breakdown.t_runtime

    def spec(self) -> str:
        return self.point.spec()

    def predicted_gups(self, g: CBCTGeometry) -> float:
        return gups_end_to_end(g, self.breakdown)


def _quantized_predicted(seconds: float) -> float:
    """Predicted runtime rounded to ~1% log-buckets for ranking.

    The cost model's resolution is no better than a percent or so — the
    overlap model is a max over stages, calibration fits carry residuals
    around 5-10%, and real codec/dispatch overheads are unmodeled.
    Ranking on raw floats lets sub-noise differences (e.g. a calibrated
    overlay shaving 0.3% off an fp8 candidate's allgather) outvote the
    deterministic tie-breaks that prefer wider storage and simpler
    impls — exactly the candidates whose unmodeled overheads bite.
    Bucketing the predicted term means "within ~1%" ranks as a tie and
    falls through to those stable preferences.
    """
    if seconds <= 0.0:
        return float("-inf")
    return round(math.log(seconds, 1.01))


def _rank_key(p: PlanProposal):
    pt = p.point
    return (
        not p.feasible,
        _quantized_predicted(p.predicted),
        -resolve_precision(pt.precision).storage_bytes,
        _PRECISION_ORDER.index(pt.precision),
        _RANK_SCHEDULE_ORDER.index(pt.schedule),
        pt.n_steps,
        pt.y_chunks or 0,
        _REDUCE_ORDER.index(pt.reduce),
        {"factorized": 0, "kernel": 1, "reference": 2}.get(pt.impl, 3),
        pt.grid.r,
    )


def enumerate_points(g: CBCTGeometry, grid: IFDKGrid, *,
                     schedules: Sequence[str] = _SCHEDULE_ORDER,
                     reduces: Sequence[str] = _REDUCE_ORDER,
                     precisions: Sequence[str] = _PRECISION_ORDER,
                     impls: Sequence[str] = ("factorized", "kernel"),
                     n_steps_candidates: Sequence[int] = DEFAULT_N_STEPS,
                     y_chunks_candidates: Sequence[int] = DEFAULT_Y_CHUNKS,
                     data_size: int | None = None,
                     ) -> Iterable[PlanPoint]:
    """All divisibility-valid plan points on one grid. `data_size` stamps
    the mesh's `data` axis extent onto the points (see PlanPoint)."""
    if g.n_proj % grid.n_ranks or g.n_x % grid.r:
        return
    np_local = g.n_proj // grid.n_ranks
    for schedule in schedules:
        steps = ([1] if schedule == "fused" else
                 [s for s in n_steps_candidates if np_local % s == 0])
        chunk_opts = ([None] if schedule != "chunked" else
                      [y for y in y_chunks_candidates if g.n_y % y == 0])
        for n_steps in steps:
            for y_chunks in chunk_opts:
                for reduce in reduces:
                    if reduce in SCATTER_REDUCES and grid.c == 1:
                        continue  # nothing to scatter over
                    for precision in precisions:
                        for impl in impls:
                            if impl == "kernel" and g.n_z % 2:
                                continue
                            yield PlanPoint(
                                grid=grid, schedule=schedule,
                                n_steps=n_steps, y_chunks=y_chunks,
                                reduce=reduce, precision=precision,
                                impl=impl, data_size=data_size)


def _propose(g: CBCTGeometry, point: PlanPoint,
             system: MachineSpec, hbm_bytes: int,
             vmem_budget: int | None, plan=None,
             calibration=None) -> PlanProposal:
    feasible, reason = check_feasible(g, point, hbm_bytes, vmem_budget)
    return PlanProposal(
        point=point,
        breakdown=predict_point(g, point, system, calibration),
        footprint=plan_footprint(g, point), feasible=feasible,
        reason=reason, plan=plan)


def search_grids(g: CBCTGeometry, n_devices: int, *,
                 system: MachineSpec = ABCI,
                 hbm_bytes: int = DEFAULT_HBM_BYTES,
                 vmem_budget: int | None = None,
                 top_k: int | None = 8, include_infeasible: bool = False,
                 calibration=None,
                 **enumerate_kwargs) -> list[PlanProposal]:
    """Rank the full (grid x plan) space for a hypothetical deployment of
    `n_devices` — no mesh is built, so proposals carry no buildable plan
    (the dry-run path: a deployment that does not exist yet)."""
    grids = grid_candidates(g, n_devices)
    if not grids:
        raise ValueError(
            f"no rectangular R x C deployment of {n_devices} ranks tiles "
            f"this geometry: need {n_devices} | N_p={g.n_proj} and some "
            f"divisor R of {n_devices} with R | N_x={g.n_x}")
    proposals = []
    for grid in grids:
        for point in enumerate_points(g, grid, **enumerate_kwargs):
            proposals.append(
                _propose(g, point, system, hbm_bytes, vmem_budget,
                         calibration=calibration))
    proposals.sort(key=_rank_key)
    if not include_infeasible:
        proposals = [p for p in proposals if p.feasible]
    return proposals[:top_k]


def search_plans(g: CBCTGeometry, mesh=None, *,
                 system: MachineSpec = ABCI,
                 hbm_bytes: int = DEFAULT_HBM_BYTES,
                 vmem_budget: int | None = None,
                 top_k: int | None = 8, include_infeasible: bool = False,
                 window: str = "ramlak", calibration=None,
                 device="cuda", **enumerate_kwargs) -> list[PlanProposal]:
    """Rank buildable plans on a concrete mesh (or single device).

    Every proposal's `plan` is a `ReconstructionPlan` on `device` that has
    passed `validate()`; candidates validate() rejects (scatter without a
    data axis, chunk extents that do not divide over it, ...) are dropped.
    """
    from ..core.plan import ReconstructionPlan
    from ..parallel.mesh import AXIS_DATA, axis_size

    if mesh is None or AXIS_DATA not in mesh.mesh_dim_names:
        enumerate_kwargs.setdefault("reduces", ("psum",))
    else:
        enumerate_kwargs.setdefault("data_size",
                                    axis_size(mesh, AXIS_DATA))
    grid = ReconstructionPlan(geometry=g, mesh=mesh, device=device).grid

    proposals = []
    for point in enumerate_points(g, grid, **enumerate_kwargs):
        plan = ReconstructionPlan(
            geometry=g, mesh=mesh, impl=point.impl, window=window,
            precision=point.precision, schedule=point.schedule,
            n_steps=point.n_steps, y_chunks=point.y_chunks,
            reduce=point.reduce, vmem_budget=vmem_budget, device=device)
        try:
            plan.validate()
        except ValueError:
            continue
        proposals.append(
            _propose(g, point, system, hbm_bytes, vmem_budget, plan=plan,
                     calibration=calibration))
    proposals.sort(key=_rank_key)
    if not include_infeasible:
        proposals = [p for p in proposals if p.feasible]
    return proposals[:top_k]


def admitted_impls(calibration=None, device="cuda") -> tuple[str, ...]:
    """The impl axis auto selection ranks on `device` (the card by
    default, as every entry point of the port; a host without one raises
    and names ``device="cpu"``).

    On a CUDA device both deployment impls compete on their analytic
    factors: the hand-written kernel is the deployment target there.
    Elsewhere the kernel's plain version is not one, so the analytic
    kernel factor must not rank it — but measured evidence overrides the
    prior: once the calibration store has fitted a kernel factor that
    beats reference's on this host, the kernel competes on its fitted
    number (pin impl="kernel" to force it regardless). Callers
    replicating auto_plan's search should use this instead of the raw
    enumerate default, or an unfitted impl can win a calibrated ranking
    on pure stock optimism.
    """
    if resolve_device(device).type == "cuda":
        return ("factorized", "kernel")
    impls = ["factorized"]
    if calibration is not None and calibration.admits_impl("kernel"):
        impls.append("kernel")
    return tuple(impls)


def auto_plan(g: CBCTGeometry, mesh=None, *,
              system: MachineSpec = ABCI,
              hbm_bytes: int = DEFAULT_HBM_BYTES,
              vmem_budget: int | None = None,
              measure: bool = False, top_k: int = 8,
              window: str = "ramlak", calibration="auto",
              device="cuda", **pins):
    """The `plan_from_spec(g, "auto")` resolver: best feasible plan for
    (geometry, mesh, HBM budget) under the model — optionally refined by
    timing the top-k built engines (planner/measure.py).

    `calibration` anchors the cost constants to this host:
      "auto" (default)     — the calibration store's fitted overlay when
                             enough traced samples exist (planner/
                             calibrate.py), stock constants otherwise;
      a MachineCalibration — used as given;
      a MachineSpec        — caller-supplied constants, no overlay;
      None                 — stock constants, calibration off.

    `pins` fix search dimensions the caller chose (e.g. precision="bf16"
    restricts the precision axis; n_steps=4 the micro-batching). The
    plans run on `device` (the card by default). Raises ValueError when no
    candidate is both valid and feasible.
    """
    from .calibrate import resolve_calibration

    cal, system = resolve_calibration(calibration, system)

    kw = {}
    schedule = pins.pop("schedule", None)
    if "reduce" in pins:
        kw["reduces"] = (pins.pop("reduce"),)
    if "precision" in pins:
        prec = resolve_precision(pins.pop("precision"))
        kw["precisions"] = (prec.storage,)
    if "impl" in pins:
        kw["impls"] = (pins.pop("impl"),)
    else:
        kw["impls"] = admitted_impls(cal, device)
    # n_steps/y_chunks pins also constrain the SCHEDULE axis — a schedule
    # that ignores the knob (fused has no micro-batching, only chunked has
    # y-chunks) must not compete and silently win with the pin dropped.
    n_steps = pins.pop("n_steps", None)
    y_chunks = pins.pop("y_chunks", None)
    if n_steps is not None:
        kw["n_steps_candidates"] = (n_steps,)
        if n_steps > 1:
            if schedule == "fused":
                raise ValueError(
                    "auto-plan pins conflict: the fused schedule has no "
                    f"micro-batching to pin n_steps={n_steps} to")
            schedule_pool = (schedule,) if schedule else ("pipelined",
                                                          "chunked")
            kw["schedules"] = schedule_pool
    if y_chunks is not None:
        if schedule not in (None, "chunked"):
            raise ValueError(
                "auto-plan pins conflict: y_chunks only applies to the "
                f"chunked schedule, not {schedule!r}")
        kw["y_chunks_candidates"] = (y_chunks,)
        kw["schedules"] = ("chunked",)
    if schedule is not None and "schedules" not in kw:
        kw["schedules"] = (schedule,)
    if pins:
        raise ValueError(
            f"auto-plan cannot pin {sorted(pins)}; pinnable dimensions: "
            "schedule, reduce, precision, impl, n_steps, y_chunks")

    candidates = search_plans(
        g, mesh, system=system, hbm_bytes=hbm_bytes,
        vmem_budget=vmem_budget, top_k=None, include_infeasible=True,
        window=window, calibration=cal, device=device, **kw)
    if not candidates:
        raise ValueError(
            "auto-plan found no valid candidate for this (geometry, mesh) "
            "under the pinned dimensions — check the pipeline divisibility "
            f"rules (N_p={g.n_proj} over the ranks and n_steps, "
            f"N_y={g.n_y} over y_chunks, scatter needs a data axis) "
            "and loosen the pins")
    feasible = [p for p in candidates if p.feasible]
    if not feasible:
        worst = candidates[0]
        raise ValueError(
            f"all {len(candidates)} candidate plans exceed the memory "
            f"budget (HBM = {hbm_bytes / 2**30:.2f} GiB) — best-ranked "
            f"[{worst.spec()}]: {worst.reason}; raise the budget or loosen "
            "the pinned dimensions")
    proposals = feasible[:top_k]
    if measure and schedule != "incremental":
        # incremental plans build sessions, not batch callables — there is
        # no single engine call for refine() to time.
        from .measure import refine
        proposals = refine(g, proposals)
    return proposals[0].plan
