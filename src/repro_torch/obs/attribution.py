"""Predicted-vs-measured attribution: planner cost model against the tracer.

Port of `repro/obs/attribution.py`, reading the port's `Tracer`.

The planner reproduces the paper's Eq. 8-19 cost model (`planner/cost.py`
-> `PerfBreakdown`), and the traced engine (`ReconstructionPlan.
build_traced`) measures the SAME pipeline stage by stage. This module
joins the two: every engine-stage span maps onto the `PerfBreakdown` field
the model predicts for it, and `compare()` emits one row per stage with
the per-stage model error — the validation loop that turns a cost model
from a heuristic into a tool (cf. Treibig et al., PAPERS.md).

Attribution mapping:

    span name           PerfBreakdown      engine stage
    ----------------    ---------------    ---------------------------------
    stage.read          t_read  (Eq. 8)    ProjectionSource scatter-read
    stage.filter        t_flt   (Eq. 9)    ramp filter + codec encode
    stage.allgather     t_allgather (10)   column AllGather (wire bytes)
    stage.backproject   t_bp    (Eq. 12)   slab back-projection
    stage.reduce        t_reduce (Eq. 15)  row-reduce epilogue + FDK scale
    stage.write         t_write (Eq. 16)   VolumeSink slice-per-rank store

`t_h2d`/`t_d2h` (Eqs. 11/14) have no standalone measured counterpart on a
device-resident engine — the model folds t_h2d into t_bp (Eq. 12) and the
engine never stages through a host bus — so they are attributed inside the
backproject row, matching `PerfBreakdown.t_bp`'s own definition.

Measured time for a stage is the SUM of its span durations in the trace
(a pipelined engine emits one span per micro-batch; attribution compares
totals, which is what the model predicts too).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Union

from .trace import Tracer

__all__ = ["STAGE_FIELDS", "AttributionRow", "aggregate_error", "compare",
           "render_report", "stage_totals"]

# Engine-stage span name -> PerfBreakdown field. Fixed vocabulary: the
# traced engine emits exactly these names (core/plan.py build_traced), and
# tests assert the two sides stay joined.
STAGE_FIELDS: Dict[str, str] = {
    "stage.read": "t_read",
    "stage.filter": "t_flt",
    "stage.allgather": "t_allgather",
    "stage.backproject": "t_bp",
    "stage.reduce": "t_reduce",
    "stage.write": "t_write",
}


@dataclasses.dataclass(frozen=True)
class AttributionRow:
    """One stage's predicted-vs-measured join.

    error is measured/predicted - 1 (positive: slower than modeled), None
    when the model predicts zero for the stage (nothing to attribute
    against — e.g. t_reduce on a C == 1 grid).
    """

    stage: str            # span name, e.g. "stage.backproject"
    field: str            # PerfBreakdown field, e.g. "t_bp"
    predicted_s: float
    measured_s: float
    n_spans: int

    @property
    def error(self) -> Optional[float]:
        if self.predicted_s <= 0.0:
            return None
        return self.measured_s / self.predicted_s - 1.0


def stage_totals(trace: Union[Tracer, dict, Iterable[dict]]
                 ) -> Dict[str, Dict[str, float]]:
    """{span name: {"seconds": total, "n": count}} for every ``stage.*``
    span in `trace` — a Tracer, an exported ``{"traceEvents": [...]}``
    object (e.g. json.load of a saved trace), or a bare event list."""
    if isinstance(trace, Tracer):
        events = trace.spans("stage.")
    else:
        events = trace.get("traceEvents", []) if isinstance(trace, dict) \
            else list(trace)
        events = [e for e in events
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("stage.")]
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        t = out.setdefault(e["name"], {"seconds": 0.0, "n": 0})
        t["seconds"] += e["dur"] / 1e6         # trace durs are µs
        t["n"] += 1
    return out


def compare(plan, trace, system=None,
            calibration=None) -> List[AttributionRow]:
    """Join the plan's modeled `PerfBreakdown` with a measured trace.

    plan   : the ReconstructionPlan the traced run executed.
    trace  : Tracer / exported trace dict / event list containing the
             ``stage.*`` spans of a `plan.build_traced()` run.
    system : MachineSpec the prediction is priced on (default ABCI).
    calibration : optional planner.calibrate.MachineCalibration overlay —
             the calibrated prediction's attribution (drift checks compare
             stock rows against calibrated rows of the same trace).

    Returns one `AttributionRow` per mapped stage, in pipeline order —
    including rows the model predicts as zero (error None) and rows the
    trace never measured (measured 0.0, n_spans 0; a plan run without a
    source/sink legitimately has no read/write spans). Every NONZERO
    predicted stage of the breakdown therefore gets a row; whether it got
    a measured counterpart is `n_spans > 0` (asserted in tests for a
    traced source->engine->sink run).
    """
    from ..planner.cost import predict_plan
    if system is None:
        bd = predict_plan(plan, calibration=calibration)
    else:
        bd = predict_plan(plan, system, calibration=calibration)
    measured = stage_totals(trace)
    rows = []
    for stage, field in STAGE_FIELDS.items():
        m = measured.get(stage, {"seconds": 0.0, "n": 0})
        rows.append(AttributionRow(
            stage=stage, field=field,
            predicted_s=float(getattr(bd, field)),
            measured_s=m["seconds"], n_spans=m["n"]))
    return rows


def aggregate_error(rows: Iterable[AttributionRow]) -> Optional[float]:
    """Time-weighted aggregate model error over an attribution report:

        sum(measured * |error|) / sum(measured)

    over the rows that can be attributed (predicted > 0 AND measured, i.e.
    n_spans > 0) — each stage's relative error weighted by the wall time it
    actually consumed, so a 50%-off 2 s back-projection dominates a
    50%-off 1 ms reduce. None when no row qualifies (nothing measured, or all-zero model)."""
    num = den = 0.0
    for r in rows:
        if r.error is None or r.n_spans <= 0 or r.measured_s <= 0:
            continue
        num += r.measured_s * abs(r.error)
        den += r.measured_s
    return None if den <= 0 else num / den


def render_report(rows: List[AttributionRow]) -> str:
    """Fixed-width predicted-vs-measured table (CLIs, bench footers)."""
    lines = [f"{'stage':<18} {'field':<12} {'predicted':>12} "
             f"{'measured':>12} {'spans':>6} {'error':>9}"]
    for r in rows:
        err = "-" if r.error is None else f"{r.error:+8.1%}"
        lines.append(
            f"{r.stage:<18} {r.field:<12} {r.predicted_s:>12.6f} "
            f"{r.measured_s:>12.6f} {r.n_spans:>6d} {err:>9}")
    return "\n".join(lines)
