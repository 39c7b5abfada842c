"""Auto-planner: perf-model-driven plan search.

Port of `repro/planner/__init__.py`, with the same exports.

Turns the paper's §4.2 performance model into a decision engine: enumerate
the grid x schedule x reduce x precision x impl space a
`ReconstructionPlan` exposes, prune what cannot fit in device memory, rank
the survivors by modeled runtime (Eq. 17-19, plan-aware), and optionally
refine the top-k by timing the built engines.

    from repro_torch.planner import auto_plan, search_plans, search_grids
    plan = auto_plan(geometry, mesh)            # best feasible plan
    table = search_grids(geometry, n_devices=256, include_infeasible=True)

or, one string from anywhere the plan API reaches:

    plan = plan_from_spec(geometry, "auto", mesh=mesh)
    plan = plan_from_spec(geometry, "auto,precision=bf16")   # pinned axis
"""
from .calibrate import CalibrationStore, MachineCalibration, \
    default_calibration, default_store, record_traced_run, \
    resolve_calibration, set_default_store
from .cost import IMPL_GUPS_FACTOR, PlanPoint, point_from_plan, \
    predict_plan, predict_point
from .feasibility import DEFAULT_HBM_BYTES, MemoryFootprint, \
    check_feasible, plan_footprint
from .measure import measure_proposal, refine
from .search import PlanProposal, admitted_impls, auto_plan, \
    enumerate_points, search_grids, search_plans

__all__ = [
    "CalibrationStore", "MachineCalibration", "default_calibration",
    "default_store", "record_traced_run", "resolve_calibration",
    "set_default_store",
    "IMPL_GUPS_FACTOR", "PlanPoint", "point_from_plan", "predict_plan",
    "predict_point", "DEFAULT_HBM_BYTES", "MemoryFootprint",
    "check_feasible", "plan_footprint", "measure_proposal", "refine",
    "PlanProposal", "admitted_impls", "auto_plan", "enumerate_points",
    "search_grids", "search_plans",
]
