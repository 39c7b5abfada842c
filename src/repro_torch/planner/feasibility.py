"""Per-device memory-footprint model + feasibility pruning.

Port of `repro/planner/feasibility.py`: `plan_footprint` verbatim; the
kernel branch of `check_feasible` reads the Hopper kernel's shared-memory
floor (kernels/backproject/tune.py `min_smem_bytes`) against a per-block
shared-memory budget, where the reference reads its Pallas kernel's VMEM
floor. The two rules differ: this kernel can gather every projection
from global memory (a staging budget of 0), so no detector is too wide
for it, where the Pallas kernel needs a whole projection batch in VMEM.

The paper sizes its grid from memory first (Eq. 5-7: R is the smallest slab
count whose sub-volume fits a GPU) and only then optimizes time. This module
is that first stage for the full plan space: a byte model of what ONE device
holds live at the peak of each schedule, checked against an HBM budget, plus
the kernel-level shared-memory fit (tune.smem_bytes) for impl="kernel".

Footprint terms (per device, peak):

  proj_shard  raw f32 input shard, N_p/(R*C) projections (Eq. 5 load split).
  gathered    the post-AllGather filtered column batch in the stream
              codec's WIRE format — quantized data plus the per-projection
              scale sidecar of scaled codecs (fp8), the same
              `Precision.wire_bytes` the engine gathers:
              N_p/(C*n_steps) projections — double-buffered under the
              pipelined/chunked schedules (batch s gathers while s-1
              back-projects, Fig. 4).
  slab        live volume accumulator state (f32):
                fused      one (N_x/R, N_y, N_z) slab (the BP output);
                pipelined  2x — the scan carry accumulator plus the current
                           batch's BP output before the add;
                chunked    the accumulator (scattered over the data axis
                           under the scatter reduces — the whole point of
                           the schedule) plus 2 chunk-sized partials; the
                           compensated reduce (scatter_bf16) additionally
                           carries a full-slab f32 error-feedback buffer.
                incremental the RESIDENT session state (core/plan.py
                           IncrementalSession) — old + new accumulator
                           live across the fold (no donation): 2x the
                           full slab under psum, 2x the 1/data-scattered
                           slab plus one full-width per-delta partial
                           under the scatter reduces; scatter_bf16 adds
                           the full-slab f32 error-feedback carry.
  temps       filter workspace: the per-step local batch at f32 plus its
              FFT pad (~2x).

The model is deliberately coarse — it decides FEASIBILITY (can this plan
run at all), not allocation; a workspace margin is the caller's business
via the budget it passes.
"""
from __future__ import annotations

import dataclasses

from ..core.distributed import SCATTER_REDUCES
from ..core.geometry import CBCTGeometry
from ..core.precision import resolve_precision

from .cost import PlanPoint

# Default per-device memory budget: 16 GiB, the paper's V100 (and the
# reference's default, kept for parity; an H100 holds 80 GB).
DEFAULT_HBM_BYTES = 16 * 2**30


@dataclasses.dataclass(frozen=True)
class MemoryFootprint:
    """Peak live bytes on one device, by pipeline stage."""

    proj_shard: int
    gathered: int
    slab: int
    temps: int

    @property
    def total(self) -> int:
        return self.proj_shard + self.gathered + self.slab + self.temps


def plan_footprint(g: CBCTGeometry, point: PlanPoint) -> MemoryFootprint:
    grid = point.grid
    prec = resolve_precision(point.precision)
    pix = g.n_u * g.n_v
    scatter = point.reduce in SCATTER_REDUCES

    np_local = g.n_proj // grid.n_ranks          # loaded per rank (Eq. 5)
    proj_shard = np_local * pix * 4

    np_step_col = g.n_proj // (grid.c * point.n_steps)   # gathered per step
    # fused gathers once; pipelined/chunked double-buffer (batch s gathers
    # while s-1 back-projects); incremental holds one delta at a time (its
    # deltas arrive from outside — nothing to overlap with).
    buffers = 1 if point.schedule in ("fused", "incremental") else 2
    # Wire format: quantized data + scale sidecar (the same bytes the
    # engine's gather_batch holds after the AllGather).
    gathered = buffers * prec.wire_bytes(np_step_col, g.n_v, g.n_u)

    nx_slab = g.n_x // grid.r
    slab_f32 = nx_slab * g.n_y * g.n_z * 4
    if point.schedule == "fused":
        slab = slab_f32
    elif point.schedule == "pipelined":
        slab = 2 * slab_f32
    elif point.schedule == "incremental":
        # The session's resident state (`session_resident_bytes`, the
        # scatter_bf16 carry included) and what a fold holds beside it: the
        # NEW accumulator while the old one is still live (no donation),
        # and under the scatter modes one full-width partial per delta
        # before its psum_scatter.
        slab = session_resident_bytes(g, point) + slab_f32 // _scatter_div(
            point)
        if scatter:
            slab += slab_f32
    else:  # chunked
        y_chunks = point.y_chunks or 1
        chunk = nx_slab * (g.n_y // y_chunks) * g.n_z * 4
        slab = slab_f32 // _scatter_div(point) + 2 * chunk
    if point.reduce == "scatter_bf16" and point.schedule != "incremental":
        # The half-width reduce is not free in memory: chunked holds the
        # full-slab f32 error-feedback buffer; fused/pipelined materialize
        # a bf16 copy of the slab for the wire.
        slab += (slab_f32 if point.schedule == "chunked"
                 else slab_f32 // 2)

    temps = 2 * (np_local // max(1, point.n_steps)) * pix * 4
    return MemoryFootprint(proj_shard, gathered, slab, temps)


def session_resident_bytes(g: CBCTGeometry, point: PlanPoint) -> int:
    """What one incremental session (core/plan.py IncrementalSession)
    holds on a device between its folds: the f32 slab accumulator,
    1/data-scattered under the scatter reduces, plus scatter_bf16's
    full-slab error-feedback carry. The part of `plan_footprint`'s slab
    term that stays resident while a stream waits for its next delta; the
    service prices its open streams by it."""
    slab_f32 = (g.n_x // point.grid.r) * g.n_y * g.n_z * 4
    resident = slab_f32 // _scatter_div(point)
    if point.reduce == "scatter_bf16":
        # the error-feedback carry turned along the time axis
        resident += slab_f32
    return resident


def _scatter_div(point: PlanPoint) -> int:
    """What a scatter reduce divides the slab accumulator by (1 for the
    others): it is scattered over the DATA axis only (the pod axis
    finishes with a replicated psum), so grid.c is the divisor only when
    the whole column group is the data axis."""
    if point.reduce not in SCATTER_REDUCES:
        return 1
    return point.data_size or point.grid.c


def check_feasible(g: CBCTGeometry, point: PlanPoint,
                   hbm_bytes: int = DEFAULT_HBM_BYTES,
                   vmem_budget: int | None = None) -> tuple[bool, str]:
    """(feasible, reason). reason is "" when feasible, else human-readable.

    Checks the device-memory footprint model and, for impl="kernel",
    whether ANY launch shape of the back-projection kernel fits the
    per-block shared-memory budget `vmem_budget` (default: the H100's
    opt-in maximum, tune.DEFAULT_SMEM_BUDGET; kernels/backproject/tune.py
    working-set model).
    """
    fp = plan_footprint(g, point)
    if fp.total > hbm_bytes:
        return False, (
            f"footprint {fp.total / 2**30:.2f} GiB exceeds the HBM budget "
            f"of {hbm_bytes / 2**30:.2f} GiB (proj {fp.proj_shard >> 20} MiB"
            f" + gathered {fp.gathered >> 20} MiB + slab {fp.slab >> 20} MiB"
            f" + temps {fp.temps >> 20} MiB)")
    if point.impl == "kernel":
        if g.n_z % 2:
            return False, f"impl='kernel' requires even N_z, got {g.n_z}"
        from ..core.plan import bp_call_shape
        from ..kernels.backproject import tune
        grid = point.grid
        nx_call, ny_call, np_call = bp_call_shape(
            g, grid.r, grid.c, point.schedule, point.n_steps,
            point.y_chunks)
        prec = resolve_precision(point.precision)
        budget = (tune.DEFAULT_SMEM_BUDGET if vmem_budget is None
                  else vmem_budget)
        need = tune.min_smem_bytes(prec.storage_dtype)
        if need > budget:
            return False, (
                f"no kernel launch shape for ({nx_call}, {ny_call}, "
                f"Np={np_call}) fits shared memory: minimal working set "
                f"{need} B > budget {budget} B per block")
    return True, ""
