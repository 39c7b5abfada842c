"""Plan-aware cost model: Eqs. 8-19 specialized to a plan point.

Port of `repro/planner/cost.py`: pure arithmetic, so the same inputs give
the same floats as the reference.

`core/perf_model.predict` is the paper's model verbatim — f32 data, the
pipelined overlap of Eq. 17 baked in. A `ReconstructionPlan` moves every one
of those assumptions into a knob, so the planner's cost function re-derives
the terms per plan point:

  stream codec    load/AllGather/H2D bytes scale with the codec's wire
                  itemsize (perf_model's `storage_bytes`) plus the
                  per-projection scale sidecar of scaled codecs (fp8:
                  `sidecar_bytes`) — the SAME `Precision.wire_bytes`
                  formula the engine encodes with, so model and engine
                  agree on every wire byte.
  schedule        fused      — no overlap: T_compute is the SUM of the stage
                               times (one gather, one back-projection, no
                               Fig. 4 pipeline to hide anything behind);
                  pipelined  — Eq. 17 verbatim: T_compute = max(stages),
                               plus a per-micro-batch launch overhead so the
                               model does not ask for n_steps -> infinity;
                  chunked    — pipelined, plus the back-projection re-streams
                               the gathered projection batch once per y-chunk
                               (the Q^T tile is re-read for every output
                               chunk), an HBM-traffic term on T_bp.
                  incremental — the streaming session (build_incremental):
                               n_steps deltas arrive from OUTSIDE the
                               pipeline, so there is no intra-pipeline
                               overlap to model (overlap=False); the
                               scatter reduces run once PER DELTA (the
                               resident accumulator stays scattered),
                               multiplying the reduce term by n_steps,
                               while psum defers its one reduce to
                               finalize(). What the mode buys is latency,
                               not throughput — `time_from_last_delta`
                               below prices it.
  reduce          psum (allreduce) moves ~2x the bytes of psum_scatter per
                  rank (2(C-1)/C vs (C-1)/C ring traffic) — the volume
                  Reduce term sees the mode — and scatter_bf16 halves the
                  scatter bytes again (bf16 slabs on the wire, perf_model's
                  `reduce_bytes`). The mode also sets the PFS *writer*
                  count for T_write (Eq. 16, the shard store's
                  slice-per-rank files): the scatter modes leave the volume
                  sharded over R x data ranks that all stream their own
                  file, psum leaves one slab owner per row — R writers.
                  Visible only when `MachineSpec.bw_rank_io` caps per-rank
                  PFS links; with the paper's aggregate-bandwidth
                  assumption both modes saturate the filesystem equally.
  impl            relative back-projection throughput factors: the reference
                  projects full (u, v, w) coordinates per voxel (~8x the
                  factorized work, Alg. 2 vs Alg. 4); the kernel's
                  dual-slab streaming buys a modest margin over the
                  factorized path. The reference's analytic ordering,
                  kept for parity; the calibration store fits this
                  host's measured factors (calibrate.py).

All constants still come from `SystemConstants`; this module only decides
how the plan combines them.
"""
from __future__ import annotations

import dataclasses

from ..core.distributed import (
    IFDKGrid, REDUCE_WIRE_ITEMSIZE, SCATTER_REDUCES,
)
from ..core.geometry import CBCTGeometry
from ..core.perf_model import (
    ABCI, MachineSpec, PerfBreakdown, predict,
)
from ..core.precision import resolve_precision

# Back-projection throughput relative to `gups_bp` (measured for the
# factorized path). Ratios follow the repo's own roofline notes (Alg. 2
# recomputes the full projection per voxel; the dual-slab kernel halves the
# k-loop via Theorem 1) — they order the impls, they are not measurements.
IMPL_GUPS_FACTOR = {
    "reference": 0.125,
    "factorized": 1.0,
    "kernel": 1.25,
}

# Fixed cost per pipeline micro-batch (collective launch + step
# overhead). Keeps the modeled optimum at a finite n_steps.
STEP_OVERHEAD_S = 2e-4


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    """The planner's search coordinates: every plan knob the cost model and
    the feasibility model read, plus the rank grid it would run on.

    Decoupled from `ReconstructionPlan` so the planner can cost hypothetical
    deployments (a 2048-device grid) without building a mesh; `search.py`
    attaches a real plan when the mesh exists.

    `data_size` is the extent of the mesh's `data` axis — the axis
    reduce="scatter" actually shards over (the engine leaves the pod axis
    replicated). None means "unknown mesh": the feasibility model then
    assumes all C columns scatter, the single-pod case.
    """

    grid: IFDKGrid
    schedule: str = "fused"
    n_steps: int = 1
    y_chunks: int | None = None
    reduce: str = "psum"
    precision: str = "fp32"
    impl: str = "factorized"
    data_size: int | None = None

    def spec(self) -> str:
        """The `plan_from_spec` string reproducing this point."""
        items = [f"schedule={self.schedule}"]
        if self.schedule != "fused":
            items.append(f"n_steps={self.n_steps}")
        if self.y_chunks is not None:
            items.append(f"y_chunks={self.y_chunks}")
        items += [f"reduce={self.reduce}", f"precision={self.precision}",
                  f"impl={self.impl}"]
        return ",".join(items)


def point_from_plan(plan) -> PlanPoint:
    """Project a ReconstructionPlan onto the planner's search coordinates."""
    return PlanPoint(
        grid=plan.grid, schedule=plan.schedule, n_steps=plan.n_steps,
        y_chunks=plan.y_chunks, reduce=plan.reduce,
        precision=plan.resolved_precision().storage, impl=plan.impl,
        data_size=plan._data_size if plan.mesh is not None else None,
    )


def io_writers(point: PlanPoint) -> int:
    """Concurrent PFS writers of the volume under this plan: with a scatter
    reduce every rank of the R x data grid holds (and streams) its own
    disjoint piece; with psum the slab is replicated across the column, so
    one owner per row — R writers."""
    grid = point.grid
    if point.reduce in SCATTER_REDUCES:
        return grid.r * (point.data_size or grid.c)
    return grid.r


def allgather_wire_bytes(g: CBCTGeometry, point: PlanPoint) -> int:
    """Total bytes the column AllGather RECEIVES across all ranks under
    this plan: each of the R*C ranks ends up holding its column's N_p/C
    projections, (R-1)/R of which arrive over the wire, in the stream
    codec's format (quantized data + scale sidecar). Zero on a 1-rank
    column (nothing to gather). The engine-side counterpart is
    `EncodedStream.nbytes` of the gathered batches — one formula
    (`Precision.wire_bytes`) serves both."""
    grid = point.grid
    if grid.r == 1:
        return 0
    prec = resolve_precision(point.precision)
    per_rank = prec.wire_bytes(g.n_proj // grid.c, g.n_v, g.n_u)
    return grid.n_ranks * per_rank * (grid.r - 1) // grid.r


def reduce_wire_bytes(g: CBCTGeometry, point: PlanPoint) -> int:
    """Total bytes the row Reduce moves across all ranks under this plan.

    The accounting mirrors the engine's reduce_slab epilogue, which runs
    PER AXIS: psum is a full-slab f32 allreduce over the data axis and
    then over the pods (2(D-1)/D + 2(P-1)/P slab bytes per rank); the
    scatter modes psum_scatter over the DATA axis only — (D-1)/D slab
    bytes per rank at the mode's wire width (bf16 for scatter_bf16) —
    followed, on multi-pod grids, by an f32 psum of the already
    1/D-scattered slab across the C/D pods. `data_size=None` (unknown
    mesh) assumes the whole column is the data axis, the same convention
    as `io_writers`."""
    grid = point.grid
    if grid.c == 1:
        return 0
    slab4 = (g.n_x // grid.r) * g.n_y * g.n_z * 4
    d = point.data_size or grid.c
    pods = grid.c // d
    if point.reduce == "psum":
        per_rank = 2 * slab4 * (d - 1) // d
        if pods > 1:
            per_rank += 2 * slab4 * (pods - 1) // pods
        return grid.n_ranks * per_rank
    wire = slab4 * REDUCE_WIRE_ITEMSIZE[point.reduce] // 4
    per_rank = wire * (d - 1) // d
    if point.schedule == "incremental":
        # the resident accumulator stays scattered: every delta
        # psum_scatters its full-width partial slab — n_steps scatters
        # instead of one (the price of bounded streaming state).
        per_rank *= max(1, point.n_steps)
    if pods > 1:     # f32 cross-pod finish on the scattered slab
        per_rank += 2 * (slab4 // d) * (pods - 1) // pods
    return grid.n_ranks * per_rank


def predict_point(g: CBCTGeometry, point: PlanPoint,
                  system: MachineSpec = ABCI,
                  calibration=None) -> PerfBreakdown:
    """Plan-aware Eqs. 8-19: the paper model with the plan's knobs applied.

    `calibration` (a planner.calibrate.MachineCalibration, or None) anchors
    the constants to this host's measured stage times: the stage-scale
    overlay re-derives the filter/AllGather/reduce/PFS constants
    (MachineSpec.with_overlay), the per-impl back-projection scale corrects
    the analytic IMPL_GUPS_FACTOR ordering with fitted evidence, and the
    fitted per-step dispatch overhead replaces STEP_OVERHEAD_S. Unfitted
    constants keep their stock values, so calibration=None reproduces the
    uncalibrated model bit-for-bit."""
    step_overhead = STEP_OVERHEAD_S
    if calibration is not None:
        system = calibration.apply(system)
        step_overhead = calibration.step_overhead()
    prec = resolve_precision(point.precision)
    sb = float(prec.storage_bytes)
    grid = point.grid
    base = predict(
        g, grid, system, storage_bytes=sb,
        sidecar_bytes=float(prec.sidecar_bytes(g.n_proj)),
        reduce_bytes=float(REDUCE_WIRE_ITEMSIZE[point.reduce]))

    # impl-aware back-projection: rescale the update-rate part of Eq. 12
    # (t_bp = t_h2d + updates/gups); the H2D part is traffic, not compute.
    factor = IMPL_GUPS_FACTOR.get(point.impl)
    if factor is None:
        raise ValueError(
            f"unknown impl {point.impl!r}; choose from "
            f"{sorted(IMPL_GUPS_FACTOR)}")
    t_update = (base.t_bp - base.t_h2d) / factor
    if calibration is not None:
        bp_scale = calibration.bp_scale(point.impl)
        if bp_scale is not None:
            t_update *= bp_scale
    t_bp = base.t_h2d + t_update

    # chunked: the gathered Q^T batch is re-streamed from HBM once per
    # y-chunk (each output chunk reads every projection of the batch), so
    # (y_chunks - 1) extra passes over the per-column projection bytes.
    if point.schedule == "chunked":
        y_chunks = point.y_chunks or 1
        qt_bytes = sb * g.n_u * g.n_v * (g.n_proj / grid.c)
        t_bp += (y_chunks - 1) * qt_bytes / (system.bw_hd
                                             * system.n_hd_links)

    # pipelined/chunked: per-micro-batch launch overhead (finite n_steps).
    if point.schedule != "fused":
        t_bp += point.n_steps * step_overhead

    # reduce-mode-aware volume traffic: ring allreduce (psum) moves
    # 2(C-1)/C x the slab bytes per rank, reduce-scatter (C-1)/C x.
    c = grid.c
    if c == 1:
        t_reduce = 0.0
    else:
        ring = (c - 1) / c
        t_reduce = base.t_reduce * ring * (2.0 if point.reduce == "psum"
                                           else 1.0)
        if (point.schedule == "incremental"
                and point.reduce in SCATTER_REDUCES):
            # one full-width psum_scatter per delta (reduce_wire_bytes).
            t_reduce *= max(1, point.n_steps)

    # T_write (Eq. 16) with the plan's writer count: the shard store's
    # slice-per-rank files mean the scatter epilogue brings R*C_data
    # concurrent writers to the PFS, psum only R. Only bites when per-rank
    # links are the bottleneck (bw_rank_io set); under the paper's
    # aggregate assumption base.t_store already has the R-writer price.
    t_store = (4.0 * g.n_x * g.n_y * g.n_z
               / system.agg_write_bw(io_writers(point)))

    # Overlap needs something to overlap WITH: a pipelined/chunked schedule
    # at n_steps=1 degenerates to one gather + one back-projection (the
    # engine's loop has one step), so Eq. 17's max only applies when the
    # stream is actually micro-batched. The incremental schedule never
    # overlaps internally — its deltas arrive from outside the pipeline.
    return dataclasses.replace(
        base, t_bp=t_bp, t_reduce=t_reduce, t_store=t_store,
        overlap=(point.schedule in ("pipelined", "chunked")
                 and point.n_steps > 1),
    )


def time_from_last_delta(g: CBCTGeometry, point: PlanPoint,
                         system: MachineSpec = ABCI,
                         calibration=None) -> float:
    """Modeled seconds from the LAST projection landing to the finished
    volume under an incremental plan — the streaming mode's figure of merit
    (chip_smoke.py's [incremental] phase measures it). The arrival-side stages of
    the final delta (filter + encode + AllGather — per-projection
    independent, `IncrementalSession.stage`) overlap the tail of
    acquisition, so the modeled tail is one delta's back-projection fold,
    plus the finalize epilogue (the per-delta psum_scatter under the
    scatter reduces; the single deferred reduce under psum) and the store.
    The batch counterpart is the full plan's `t_runtime` — streaming wins
    when this is ~1/n_steps of that."""
    if point.schedule != "incremental":
        raise ValueError(
            f"time_from_last_delta prices schedule='incremental' points, "
            f"got {point.schedule!r}")
    bd = predict_point(g, point, system, calibration)
    step_overhead = (STEP_OVERHEAD_S if calibration is None
                     else calibration.step_overhead())
    n = max(1, point.n_steps)
    # one delta's fold: the per-delta slice of the BP stage (+ the one
    # per-micro-batch overhead predict_point charged n times). The staged
    # arrival work (t_flt, t_allgather, t_h2d) rode along with acquisition.
    per_delta = ((bd.t_bp - bd.t_h2d - n * step_overhead) / n
                 + step_overhead)
    if point.reduce in SCATTER_REDUCES:
        finalize = bd.t_reduce / n          # the last delta's scatter
    else:
        finalize = bd.t_reduce              # psum deferred to finalize()
    return per_delta + finalize + bd.t_d2h + bd.t_store


def predict_plan(plan, system: MachineSpec = ABCI,
                 calibration=None) -> PerfBreakdown:
    """Plan-aware cost of a concrete ReconstructionPlan."""
    return predict_point(plan.geometry, point_from_plan(plan), system,
                         calibration)
