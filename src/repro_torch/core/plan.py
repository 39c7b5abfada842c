"""Declarative reconstruction plans + the staged engine, on one device or a
mesh of ranks.

Port of `repro/core/plan.py`:

    plan = ReconstructionPlan(geometry=g, impl="kernel", precision="fp16")
    fdk = plan.build()          # validated, cached per plan
    volume = fdk(projections)   # (N_p, N_v, N_u) -> (N_x, N_y, N_z) f32

and, on every rank of a torch.distributed mesh (parallel/mesh.py),

    mesh = make_mesh((pod, data, model), ("pod", "data", "model"))
    plan = ReconstructionPlan(geometry=g, mesh=mesh, schedule="pipelined",
                              n_steps=4, reduce="scatter")
    local = plan.build()(local_projections(projections, mesh))

A `ReconstructionPlan` is a frozen dataclass capturing every degree of
freedom of the pipeline; `validate()` centralizes the feasibility checks
and `build()` composes the stage primitives

    filter + encode      make_filter(window) then the precision's codec
    gather schedule      column AllGather of the wire bytes over `model`
    slab back-projection shift_pmats_i (x-slab) / shift_pmats_j (y-chunk)
    reduce epilogue      all-reduce (psum) | reduce-scatter over y (scatter)
    fdk_scale            once at the end

into one rank function for the fused, pipelined and chunked schedules.
Without a mesh the gather and the reduce are absent; on a mesh they go
through `distributed.Collectives`, whatever backend the caller initialised
the process group with. The plan's `device` (default "cuda") says where
everything runs; asking for the card on a host without one raises and
names ``device="cpu"``.

The plan also builds the engines around that rank function, as the
reference does:

    build(source=, sink=)   load -> engine -> store, through a
                            ProjectionSource / VolumeSink (io/streams.py)
    build_batched(B)        B same-geometry scans, lane b bit-equal to
                            build()(proj[b])
    build_incremental()     an IncrementalSession (schedule="incremental")
                            folding projection deltas as the scanner
                            writes them: the paper's instant CT

    build_traced()          the engine cut at its stage seams, each stage
                            a fenced ``stage.*`` span (a
                            `TracedIncrementalSession` for
                            schedule="incremental"); traced runs feed the
                            planner's calibration store

Every engine call, fold and stage runs in a span of the process tracer
(obs/trace.py), fenced on the card when the tracer is enabled.

For impl="kernel" the kernel's launch shape (tile, staging bytes) is
resolved once at plan time by the tuner (kernels/backproject/tune.py,
file-backed cache); `blocks` pins the tile and `vmem_budget` bounds the
per-block shared memory. `plan_from_spec(g, "auto")` resolves through the
planner (planner/search.py).
"""
from __future__ import annotations

import dataclasses
import difflib
from functools import partial
from typing import Callable, Dict, Literal, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..obs.trace import get_tracer, wait_for
from ..parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_POD, axis_size, dp_axes,
)
from .cache import CountingLRU
from .distributed import (
    SCATTER_REDUCES, Collectives, IFDKGrid, column_pmats, shift_pmats_i,
)
from .fdk import BpImpl, _get_backprojector, fdk_scale
from .filtering import _WINDOWS, make_filter
from .geometry import CBCTGeometry, projection_matrices
from .precision import Precision, resolve_precision

Schedule = Literal["fused", "pipelined", "chunked", "incremental"]
ReduceMode = Literal["psum", "scatter", "scatter_bf16"]

_SCHEDULES = ("fused", "pipelined", "chunked", "incremental")
_REDUCES = ("psum",) + SCATTER_REDUCES
_IMPLS = ("reference", "factorized", "kernel")
_PRECISIONS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")

# build()/build_batched() results keyed by the (hashable) plan (plus the
# batch size for batched engines) and, on a mesh, the mesh's process
# groups (a new group behind an equal mesh is a new engine). Its counts
# also go to the metrics registry as cache.core.engine_cache.*.
_ENGINE_CACHE = CountingLRU(capacity=64, name="core.engine_cache")


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()


def _traced_call(fn: Callable, name: str, attrs: dict) -> Callable:
    """Wrap an engine callable in a fenced span when the process tracer is
    on. The disabled path is ONE attribute load + branch per call; `attrs`
    are fixed at build time. The span's `dispatch_us` arg is the host time
    until the launches returned, its duration dispatch + device compute
    (`Span.fence`)."""
    def call(*args, **kwargs):
        tracer = get_tracer()
        if not tracer.enabled:
            return fn(*args, **kwargs)
        with tracer.span(name, **attrs) as sp:
            out = fn(*args, **kwargs)
            sp.fence(out)
        return out
    call.__wrapped__ = fn
    return call


def engine_cache_stats() -> dict:
    """hit/miss/eviction/unhashable counters of the shared engine cache."""
    return _ENGINE_CACHE.stats()


def bp_call_shape(g: CBCTGeometry, r: int, c: int, schedule: str,
                  n_steps: int, y_chunks: Optional[int]
                  ) -> Tuple[int, int, int]:
    """(nx, ny, n_p) of ONE back-projection call under a plan point: the
    x-slab (and y-chunk, if chunked) of one gathered micro-batch."""
    nx_call = g.n_x // r
    ny_call = (g.n_y // y_chunks if schedule == "chunked" and y_chunks
               else g.n_y)
    np_call = g.n_proj // (c * n_steps)
    return nx_call, ny_call, np_call


def shift_pmats_j(pmats: torch.Tensor, j0) -> torch.Tensor:
    """Reparameterize P for a y-chunk starting at voxel index j0:
    P'[:, 3] = P[:, 3] + j0 * P[:, 1]."""
    out = pmats.clone()
    out[..., :, 3] += pmats[..., :, 1] * j0
    return out


@dataclasses.dataclass
class _Stages:
    """The engine's stage primitives, composed once per plan."""

    gather_batch: Callable   # (pm_col, raw_b, async_op) -> wait() -> columns
    filter_encode: Callable  # raw_b -> wire columns (data, scales)
    gather_cols: Callable    # (pm_col, cols, async_op) -> wait() -> columns
    slab_pmats: Callable     # pm_col -> P shifted to this rank's x-slab
    reduce_slab: Callable    # full-slab row-reduce epilogue
    scatter_compensated: Callable  # (part, carry) -> (reduced, new carry)
    backproject: Callable    # resolved impl
    nx_slab: int
    scale: float             # fdk_scale(geometry)
    coll: Optional[Collectives]
    dp: Tuple[str, ...]      # row-reduce axes present on the mesh
    data_axis: Optional[str]
    pod_axis: Optional[str]


@dataclasses.dataclass(frozen=True)
class ReconstructionPlan:
    """Everything that determines a reconstruction, in one declarative value.

    Fields
    ------
    geometry   : the CBCT scan geometry (paper Table 1).
    mesh       : a torch.distributed DeviceMesh (parallel/mesh.py), or None
                 for one device. The paper's R x C rank grid comes from it:
                 R = `model` axis (volume slabs), C = `pod` x `data`
                 (projection groups) — see `grid`.
    impl       : back-projection implementation ("reference" | "factorized"
                 | "kernel" — the hand-written CUDA kernel on the card).
    window     : ramp-filter apodization window.
    precision  : storage codec of the filtered-projection stream: a
                 Precision, a name, or None for the device's default (fp16
                 on the card, bf16 on the CPU). Accumulation is always f32.
    schedule   : "fused"     — one gather, one slab back-projection;
                 "pipelined" — `n_steps` projection micro-batches, the
                               AllGather of batch s in flight while batch
                               s-1 is back-projected (paper Fig. 4);
                 "chunked"   — pipelined, back-projecting and reducing
                               `y_chunks` y-chunks of the slab per
                               micro-batch (bounds the live slab state).
    n_steps    : projection micro-batches per rank (pipelined/chunked).
    y_chunks   : y-axis chunks (chunked only).
    reduce     : row-reduce epilogue. "psum" replicates the slab; "scatter"
                 leaves it sharded over `data` along y (needs a mesh with a
                 `data` axis); "scatter_bf16" is scatter at half the wire
                 bytes — partial slabs rounded to bf16 once per rank before
                 the reduce-scatter and the result upcast to f32, with an
                 f32 error-feedback carry under the chunked schedule.
    device     : where the plan runs, default "cuda" (on a mesh, each
                 rank's current device of that type).
    blocks     : the Hopper kernel's tile (ti, tj, tk) for impl="kernel",
                 one of the compiled `kernels.backproject.kernel.TILES`;
                 None = the tuner's pick at plan time. (The reference's
                 field of that name is its Pallas (bi, bj, bs) block.)
    vmem_budget: per-block shared-memory budget in bytes handed to the
                 tuner (None = the card's opt-in maximum). (The
                 reference's is its Pallas kernel's VMEM budget.)
    """

    geometry: CBCTGeometry
    mesh: Optional[DeviceMesh] = None
    impl: BpImpl = "factorized"
    window: str = "ramlak"
    precision: Precision | str | None = "fp32"
    schedule: Schedule = "fused"
    n_steps: int = 1
    y_chunks: Optional[int] = None
    reduce: ReduceMode = "psum"
    device: str = "cuda"
    blocks: Optional[Tuple[int, int, int]] = None
    vmem_budget: Optional[int] = None

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, DeviceMesh):
            raise TypeError(
                "mesh must be a torch.distributed DeviceMesh "
                "(repro_torch.parallel.mesh.make_mesh), got "
                f"{type(self.mesh).__name__}")
        resolve_device(self.device)

    # -- derived quantities -------------------------------------------------

    @property
    def grid(self) -> IFDKGrid:
        """The paper's R (slabs) x C (projection groups) rank grid."""
        if self.mesh is None:
            return IFDKGrid(r=1, c=1)
        return IFDKGrid(r=axis_size(self.mesh, AXIS_MODEL),
                        c=axis_size(self.mesh, AXIS_POD, AXIS_DATA))

    @property
    def _data_size(self) -> int:
        return axis_size(self.mesh, AXIS_DATA) if self.mesh is not None else 1

    def resolved_precision(self) -> Precision:
        return resolve_precision(self.precision, self.device)

    # -- validation ---------------------------------------------------------

    def validate(self) -> "ReconstructionPlan":
        """Centralized feasibility checks, with the reference's messages."""
        g = self.geometry
        if self.impl not in _IMPLS:
            raise ValueError(
                f"unknown back-projection impl {self.impl!r}; "
                f"choose from {_IMPLS}")
        if self.window not in _WINDOWS:
            raise ValueError(
                f"unknown window {self.window!r}; choose from {_WINDOWS}")
        if self.schedule not in _SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; "
                f"choose from {_SCHEDULES}")
        if self.reduce not in _REDUCES:
            raise ValueError(
                f"unknown reduce mode {self.reduce!r}; "
                f"choose from {_REDUCES}")
        self.resolved_precision()  # raises on unknown storage
        mesh = self.mesh
        if mesh is not None:
            if AXIS_MODEL not in mesh.mesh_dim_names:
                raise ValueError(
                    f"mesh axes {mesh.mesh_dim_names} lack the "
                    f"{AXIS_MODEL!r} axis that carries the paper's R volume "
                    "slabs")
            dev_type = resolve_device(self.device).type
            if mesh.device_type != dev_type:
                raise ValueError(
                    f"mesh device type {mesh.device_type!r} is not the "
                    f"plan's device type {dev_type!r}")
        grid = self.grid
        n_ranks = grid.n_ranks
        if g.n_proj % n_ranks:
            raise ValueError(
                f"N_p={g.n_proj} must divide over the {n_ranks} ranks of "
                f"the R={grid.r} x C={grid.c} grid")
        if g.n_x % grid.r:
            raise ValueError(
                f"N_x={g.n_x} must divide into R={grid.r} volume slabs")
        if self.n_steps < 1:
            raise ValueError(f"n_steps={self.n_steps} must be >= 1")
        if self.schedule == "fused" and self.n_steps != 1:
            raise ValueError(
                "the fused schedule has no micro-batching; use "
                "schedule='pipelined' (or 'chunked') for n_steps > 1")
        np_local = g.n_proj // n_ranks
        if np_local % self.n_steps:
            raise ValueError(
                f"per-rank N_p={np_local} must divide into "
                f"n_steps={self.n_steps} micro-batches")
        if self.schedule == "chunked":
            if self.y_chunks is None:
                raise ValueError("the chunked schedule requires y_chunks")
            if g.n_y % self.y_chunks:
                raise ValueError(
                    f"N_y={g.n_y} must divide into y_chunks={self.y_chunks}")
        elif self.y_chunks is not None:
            raise ValueError(
                "y_chunks only applies to the chunked schedule")
        if self.reduce in SCATTER_REDUCES:
            if mesh is None or AXIS_DATA not in mesh.mesh_dim_names:
                raise ValueError(
                    f"reduce={self.reduce!r} needs a mesh with a 'data' "
                    "axis to scatter over; use reduce='psum' on a single "
                    "device")
            scatter_extent = (g.n_y // self.y_chunks
                              if self.schedule == "chunked" else g.n_y)
            if scatter_extent % self._data_size:
                raise ValueError(
                    f"scatter extent {scatter_extent} (y) must divide over "
                    f"the data axis of size {self._data_size}")
        if self.blocks is not None and self.impl != "kernel":
            raise ValueError(
                "blocks=(ti, tj, tk) only applies to impl='kernel'")
        if self.impl == "kernel" and g.n_z % 2:
            raise ValueError(
                f"impl='kernel' requires even N_z (dual-slab layout), "
                f"got N_z={g.n_z}")
        if self.impl == "kernel":
            self._validate_launch()
        return self

    def _validate_launch(self) -> None:
        """The pinned tile is compiled, and some launch shape fits the
        shared-memory budget (the kernel takes partial tiles: no tile has
        to divide the slab)."""
        from ..kernels.backproject import tune
        from ..kernels.backproject.kernel import TILES
        if self.blocks is not None and \
                tuple(int(b) for b in self.blocks) not in TILES:
            raise ValueError(
                f"blocks={tuple(self.blocks)} is not a compiled tile of the "
                f"back-projection kernel; choose from {TILES}")
        if self.vmem_budget is not None:
            dtype = self.resolved_precision().storage_dtype
            if not tune.candidate_blocks(dtype, self.vmem_budget,
                                         fix_tile=self.blocks):
                raise ValueError(
                    f"vmem_budget={self.vmem_budget} bytes of shared memory "
                    "per block fits no launch shape of the back-projection "
                    f"kernel (the smallest needs "
                    f"{tune.min_smem_bytes(dtype)} bytes)")

    # -- kernel launch shape (plan-time, not per-call) -----------------------

    def resolved_launch(self) -> Optional[Tuple[Tuple[int, int, int], int]]:
        """(tile, staging bytes) the kernel runs with under this plan: the
        tuner's pick for the per-call back-projection shape, on the
        geometry's first n_p matrices of that call (a representative
        call), with `blocks` pinned and under `vmem_budget`. None for
        non-kernel impls."""
        if self.impl != "kernel":
            return None
        from ..kernels.backproject import tune
        g = self.geometry
        nx_call, ny_call, np_call = self.bp_call_shape()
        pm = torch.as_tensor(projection_matrices(g)[:np_call],
                             device=resolve_device(self.device))
        return tune.pick_blocks(
            nx_call, ny_call, g.n_z, pm, g.n_u, g.n_v,
            qt_dtype=self.resolved_precision().storage_dtype,
            budget=self.vmem_budget,
            fix_tile=None if self.blocks is None else tuple(self.blocks))

    def resolved_blocks(self) -> Optional[Tuple[int, int, int]]:
        """The tile this plan runs the kernel with (None for non-kernel
        impls)."""
        launch = self.resolved_launch()
        return None if launch is None else launch[0]

    def _resolve_backprojector(self) -> Callable:
        if self.impl != "kernel":
            return _get_backprojector(self.impl)
        from ..kernels.backproject.ops import backproject_kernel
        t, stage_bytes = self.resolved_launch()
        return partial(backproject_kernel, tile=t, stage_bytes=stage_bytes)

    def describe(self) -> dict:
        """Flat summary of the resolved plan (benchmark/report labels),
        with the kernel's resolved launch shape."""
        grid = self.grid
        launch = self.resolved_launch()
        return {
            "schedule": self.schedule,
            "impl": self.impl,
            "window": self.window,
            "precision": self.resolved_precision().storage,
            "grid": (grid.r, grid.c),
            "n_steps": self.n_steps,
            "y_chunks": self.y_chunks,
            "reduce": self.reduce,
            "device": str(resolve_device(self.device)),
            "blocks": None if launch is None else launch[0],
            "stage_bytes": None if launch is None else launch[1],
        }

    def bp_call_shape(self) -> Tuple[int, int, int]:
        """(nx, ny, n_p) of one back-projection call of this plan."""
        grid = self.grid
        return bp_call_shape(self.geometry, grid.r, grid.c, self.schedule,
                             self.n_steps, self.y_chunks)

    # -- engine -------------------------------------------------------------

    def _make_stages(self) -> _Stages:
        g = self.geometry
        mesh = self.mesh
        coll = Collectives(mesh) if mesh is not None else None
        dp = dp_axes(mesh) if mesh is not None else ()
        nx_slab = g.n_x // self.grid.r
        codec = self.resolved_precision().codec
        # The filter emits f32; the stream codec owns the quantization to
        # the wire format.
        filt = make_filter(g, self.window, out_dtype=torch.float32,
                           device=self.device)

        # --- stage: filter + encode + column AllGather (paper Fig. 3b) -----
        # The AllGather moves the codec's WIRE format: quantized data plus,
        # for scaled codecs (fp8, fp16's scale-on-overflow), the
        # per-projection f32 scale sidecar. The column group's P is not
        # gathered: every rank slices it from the geometry (column_pmats).
        # Split in two so the traced engines time them apart:
        # `filter_encode` is collective-free, `gather_cols` moves the wire
        # bytes over the model axis.
        def filter_encode(raw_b):
            return tuple(codec.encode(filt(raw_b)))

        def gather_cols(pm_col, cols, async_op=False):
            if coll is None:
                return lambda: (pm_col,) + cols
            issued = [None if x is None
                      else coll.all_gather(x, AXIS_MODEL, async_op)
                      for x in cols]

            def wait():
                for x in issued:
                    if x is not None and x[1] is not None:
                        x[1].wait()
                return (pm_col,) + tuple(None if x is None else x[0]
                                         for x in issued)
            return wait

        def gather_batch(pm_col, raw_b, async_op=False):
            return gather_cols(pm_col, filter_encode(raw_b), async_op)

        # --- stage: x-slab reparameterization (offset folded into P) -------
        if mesh is None:
            def slab_pmats(pm_col):
                return pm_col
        else:
            i0 = float(mesh.get_local_rank(AXIS_MODEL) * nx_slab)

            def slab_pmats(pm_col):
                return shift_pmats_i(pm_col, i0)

        # --- stage: row-reduce epilogue (fused/pipelined full slab) --------
        # "scatter_bf16" moves the partial slab at half width: round to
        # bf16, reduce-scatter, upcast — ONE rounding per rank; the
        # cross-pod finish stays f32.
        def reduce_slab(slab):
            if not dp:
                return slab
            if self.reduce in SCATTER_REDUCES:
                if self.reduce == "scatter_bf16":
                    slab = slab.to(torch.bfloat16)
                slab = coll.reduce_scatter_y(slab, dp[-1]).to(torch.float32)
                for a in dp[:-1]:  # multi-pod: finish across pods
                    slab = coll.all_reduce(slab, a)
                return slab
            for a in dp:
                slab = coll.all_reduce(slab, a)
            return slab

        # --- stage: "scatter_bf16" reduce-scatter with error feedback ------
        # Re-inject the residual this rank dropped when it rounded the
        # previous partial of the SAME region (the chunked schedule's last
        # round of a chunk, the session's previous delta), so rounding
        # error does not accumulate over the rounds: only the final
        # round's rounding survives (one per rank).
        data_axis = AXIS_DATA if AXIS_DATA in dp else None

        def scatter_compensated(part, carry):
            part = part + carry
            half = part.to(torch.bfloat16)
            red = coll.reduce_scatter_y(half, data_axis).to(torch.float32)
            return red, part - half.to(torch.float32)

        return _Stages(gather_batch=gather_batch,
                       filter_encode=filter_encode, gather_cols=gather_cols,
                       slab_pmats=slab_pmats, reduce_slab=reduce_slab,
                       scatter_compensated=scatter_compensated,
                       backproject=self._resolve_backprojector(),
                       nx_slab=nx_slab, scale=fdk_scale(g), coll=coll, dp=dp,
                       data_axis=data_axis,
                       pod_axis=AXIS_POD if AXIS_POD in dp else None)

    def _build_rank_fn(self, st: _Stages) -> Callable:
        """Compose the stage primitives into rank_fn(pm_steps, proj_local):
        pm_steps[s] is the column group's P of micro-batch s."""
        g = self.geometry
        gather_batch, slab_pmats, reduce_slab, backproject = (
            st.gather_batch, st.slab_pmats, st.reduce_slab, st.backproject)
        nx_slab, scale, coll = st.nx_slab, st.scale, st.coll
        n_steps = self.n_steps
        nb = g.n_proj // self.grid.n_ranks // n_steps

        def batches(pm_steps, proj_local):
            """Each micro-batch's gathered columns, in order. The AllGather
            of batch s is issued before batch s-1 is handed out, so it is
            in flight while s-1 is back-projected (paper Fig. 4)."""
            def issue(s):
                return gather_batch(pm_steps[s],
                                    proj_local[s * nb:(s + 1) * nb],
                                    async_op=True)
            pending = issue(0)
            for s in range(1, n_steps):
                nxt = issue(s)
                yield pending()
                pending = nxt
            yield pending()

        if self.schedule == "fused":
            def fused(pm_steps, proj_local):
                pm_col, q_col, sc_col = gather_batch(pm_steps[0],
                                                     proj_local)()
                slab = backproject(slab_pmats(pm_col), q_col,
                                   nx_slab, g.n_y, g.n_z, scales=sc_col)
                return reduce_slab(slab) * scale
            return fused

        if self.schedule == "pipelined":
            def pipelined(pm_steps, proj_local):
                acc = torch.zeros((nx_slab, g.n_y, g.n_z),
                                  dtype=torch.float32, device=proj_local.device)
                for pm_col, q_col, sc_col in batches(pm_steps, proj_local):
                    acc = acc + backproject(slab_pmats(pm_col), q_col,
                                            nx_slab, g.n_y, g.n_z,
                                            scales=sc_col)
                return reduce_slab(acc) * scale
            return pipelined

        # chunked: per-y-chunk back-projection with an immediate per-chunk
        # reduce, bounding the live slab state (output-side streaming).
        y_chunks = self.y_chunks
        yc = g.n_y // y_chunks
        scatter = self.reduce in SCATTER_REDUCES
        compensated = self.reduce == "scatter_bf16"
        yc_local = yc // self._data_size if scatter else yc
        data_axis, pod_axis = st.data_axis, st.pod_axis

        def chunked(pm_steps, proj_local):
            dev = proj_local.device
            acc = torch.zeros((nx_slab, y_chunks, yc_local, g.n_z),
                              dtype=torch.float32, device=dev)
            err = (torch.zeros((nx_slab, y_chunks, yc, g.n_z),
                               dtype=torch.float32, device=dev)
                   if compensated else None)
            for pm_col, q_col, sc_col in batches(pm_steps, proj_local):
                pm_slab = slab_pmats(pm_col)
                for ci in range(y_chunks):
                    part = backproject(shift_pmats_j(pm_slab, float(ci * yc)),
                                       q_col, nx_slab, yc, g.n_z,
                                       scales=sc_col)
                    if compensated:
                        red, err[:, ci] = st.scatter_compensated(part,
                                                                 err[:, ci])
                    elif scatter:
                        red = coll.reduce_scatter_y(part, data_axis)
                    elif data_axis is not None:
                        red = coll.all_reduce(part, data_axis)
                    else:
                        red = part
                    acc[:, ci] = acc[:, ci] + red
            if pod_axis is not None:
                acc = coll.all_reduce(acc, pod_axis)
            if not scatter:
                # dims 1,2 are contiguous locally when nothing is scattered
                acc = acc.reshape(nx_slab, g.n_y, g.n_z)
            return acc * scale
        return chunked

    def _cache_key(self):
        return (self if self.mesh is None
                else (self, tuple(self.mesh.get_all_groups())))

    def _span_attrs(self) -> dict:
        """Fixed span args of this plan's engines (trace labels), JSON-plain
        for the Perfetto export."""
        grid = self.grid
        return {
            "schedule": self.schedule,
            "impl": self.impl,
            "reduce": self.reduce,
            "precision": self.resolved_precision().storage,
            "grid": f"{grid.r}x{grid.c}",
            "n_steps": self.n_steps,
        }

    def output_spec(self) -> Optional[list]:
        """The mesh axes each dimension of this rank's output is cut over,
        in the JSON form the reference's shard store records for the same
        layout (its output PartitionSpec), or None without a mesh: x over
        `model`; y over `data` under a scatter reduce; the chunk interior
        of the 4-D chunked + scatter store over `data`."""
        if self.mesh is None:
            return None
        if self.reduce in SCATTER_REDUCES:
            if self.schedule == "chunked":
                return [AXIS_MODEL, None, AXIS_DATA, None]
            return [AXIS_MODEL, AXIS_DATA]
        return [AXIS_MODEL]

    def _engine_inputs(self):
        """(device, P per micro-batch of this rank's column group, the
        per-scan input shape, its description for errors)."""
        g = self.geometry
        dev = resolve_device(self.device)
        pm = torch.as_tensor(projection_matrices(g), device=dev)
        if self.mesh is None:
            return (dev, pm.reshape((self.n_steps, -1) + pm.shape[1:]),
                    g.proj_shape(), "(N_p, N_v, N_u)")
        return (dev, column_pmats(pm, self.mesh, self.n_steps),
                (g.n_proj // self.grid.n_ranks,) + g.proj_shape()[1:],
                "this rank's (N_p/(R*C), N_v, N_u)")

    def build(self, source=None, sink=None) -> Callable:
        """Validated reconstruction on the plan's device.

        Without a mesh: projections (N_p, N_v, N_u) -> volume
        (N_x, N_y, N_z) f32. On a mesh, every rank calls it with its own
        `local_projections(projections, mesh)` (N_p/(R*C), N_v, N_u) and
        gets its part of the volume: the x-slab (N_x/R, N_y, N_z) under
        psum, with y cut over `data` (N_x/R, N_y/C_data, N_z) under a
        scatter reduce, and the 4-D (N_x/R, y_chunks, N_y/y_chunks/C_data,
        N_z) store layout for chunked + scatter; `assemble_volume` gathers
        the global volume. Projections may be a tensor or an array; they
        are placed on the plan's device. The engine's `collectives`
        attribute (None without a mesh) counts the bytes each collective
        moved. Results are cached per plan (and mesh process groups).

        `source`/`sink` (io/streams.py) close the pipeline at the
        filesystem like the paper's ranks do: with a `ProjectionSource`
        the returned callable may be invoked with no argument — each rank
        reads only its own projection rows (span ``stage.read``); with a
        `VolumeSink` each rank's output is stored shard per file before
        it is returned (span ``stage.write``).
        """
        if self.schedule == "incremental":
            raise ValueError(
                "schedule='incremental' is stateful (projections arrive as "
                "deltas); use plan.build_incremental() to obtain a "
                "streaming session instead of build()")
        if source is not None or sink is not None:
            return self._build_with_io(source, sink)
        key = self._cache_key()
        cached = _ENGINE_CACHE.get(key)
        if cached is not None:
            return cached
        self.validate()
        st = self._make_stages()
        rank_fn = self._build_rank_fn(st)
        dev, pm_steps, shape, what = self._engine_inputs()

        def reconstruct_fn(projections) -> torch.Tensor:
            proj = torch.as_tensor(projections, device=dev)
            if tuple(proj.shape) != shape:
                raise ValueError(
                    f"projections must be {what} = {shape}, "
                    f"got {tuple(proj.shape)}")
            return rank_fn(pm_steps, proj)

        reconstruct_fn = _traced_call(reconstruct_fn, "engine.reconstruct",
                                      self._span_attrs())
        reconstruct_fn.collectives = st.coll
        _ENGINE_CACHE.put(key, reconstruct_fn)
        return reconstruct_fn

    def _build_with_io(self, source, sink) -> Callable:
        """The engine with its filesystem endpoints attached: read this
        rank's projections from `source` when none are passed, store its
        output to `sink`. The engine underneath comes from the per-plan
        cache."""
        engine = self.build()
        # chunked+scatter emits the engine's 4-D y-chunk-major layout;
        # record it in the sink's manifest so VolumeSink.read() restores
        # the canonical volume.
        layout = None
        if self.schedule == "chunked" and self.reduce in SCATTER_REDUCES:
            layout = {"kind": "y_chunk_major", "y_chunks": self.y_chunks}
        spec = self.output_spec()

        def reconstruct_io(projections=None) -> torch.Tensor:
            tracer = get_tracer()
            if projections is None:
                if source is None:
                    raise TypeError(
                        "this plan was built without a ProjectionSource; "
                        "pass the projections array")
                with tracer.span("stage.read") as sp:
                    projections = sp.fence(
                        source.load(self.mesh, device=self.device))
            volume = engine(projections)
            if sink is not None:
                wait_for(volume)
                with tracer.span("stage.write"):
                    sink.write(volume, layout=layout, mesh=self.mesh,
                               spec=spec)
            return volume

        reconstruct_io.collectives = engine.collectives
        return reconstruct_io

    def build_batched(self, batch_size: int) -> Callable:
        """Batched engine: reconstruct `batch_size` same-geometry scans in
        one call — the service layer's geometry-bucketed serving path.

        Input : (B, N_p, N_v, N_u) projections, B == batch_size (on a mesh
                (B, N_p/(R*C), N_v, N_u): this rank's rows of every scan).
        Output: (B,) + build()'s output shape, f32.

        Exactness contract: lane b of the output is BIT-IDENTICAL to
        `self.build()(projections[b])`, so a junk or NaN lane cannot
        perturb the real ones. Each lane runs build()'s schedule body in
        turn, so the filter's FFT batches see the same projections and
        batch counts as build()'s (cuFFT may pick another algorithm for
        another count, and a batch must not straddle two scans), and only
        one lane's intermediates are live at a time.

        Engines are cached per (plan, batch_size) in build()'s LRU.
        """
        if self.schedule == "incremental":
            raise ValueError(
                "schedule='incremental' is stateful; the batched serving "
                "path needs a batch schedule (fused/pipelined/chunked)")
        bsz = int(batch_size)
        if bsz < 1:
            raise ValueError(f"batch_size={batch_size} must be >= 1")
        key = (self._cache_key(), "batched", bsz)
        cached = _ENGINE_CACHE.get(key)
        if cached is not None:
            return cached
        self.validate()
        st = self._make_stages()
        rank_fn = self._build_rank_fn(st)
        dev, pm_steps, shape, what = self._engine_inputs()
        shape = (bsz,) + shape

        def batched_fn(projections) -> torch.Tensor:
            proj = torch.as_tensor(projections, device=dev)
            if tuple(proj.shape) != shape:
                raise ValueError(
                    f"projections must be (B, ) + {what} = {shape}, "
                    f"got {tuple(proj.shape)}")
            out = None
            for b in range(bsz):
                lane = rank_fn(pm_steps, proj[b])
                if out is None:
                    out = torch.empty((bsz,) + tuple(lane.shape),
                                      dtype=lane.dtype, device=lane.device)
                out[b] = lane
                del lane
            return out

        attrs = self._span_attrs()
        attrs["batch"] = bsz
        batched_fn = _traced_call(batched_fn, "engine.batched", attrs)
        batched_fn.collectives = st.coll
        _ENGINE_CACHE.put(key, batched_fn)
        return batched_fn

    def build_incremental(self, source=None, sink=None
                          ) -> "IncrementalSession":
        """Streaming reconstruction (the paper's *instant* CT): a stateful
        session that folds projection deltas into this rank's slab
        accumulator as the scanner writes them, so time-from-last-
        projection is one delta's fold plus the reduce epilogue — not the
        full pipeline.

            plan = ReconstructionPlan(geometry=g, impl="kernel",
                                      schedule="incremental", n_steps=8)
            sess = plan.build_incremental(source=ProjectionSource(dir_in),
                                          sink=VolumeSink(dir_out))
            while not sess.is_complete:
                sess.poll()          # discover + fold newly landed deltas
            volume = sess.finalize() # reduce epilogue + FDK scale only

        `n_steps` is the *nominal* delta count; at run time any contiguous,
        disjoint angle slices whose length divides over the rank grid may
        be folded, in any order. See `IncrementalSession`.
        """
        if self.schedule != "incremental":
            raise ValueError(
                f"build_incremental() needs schedule='incremental', got "
                f"{self.schedule!r} — batch schedules go through build()")
        return IncrementalSession(self, source=source, sink=sink)

    # -- traced engine (per-stage attribution) -------------------------------

    def build_traced(self, source=None, sink=None):
        """The engine cut at its stage seams, each stage a fenced span: the
        measurement counterpart of the planner's `PerfBreakdown`
        (obs/attribution.py joins the two).

        Every schedule runs the same FUSED stage decomposition here: one
        stage after another (filter + encode, column AllGather, slab
        back-projection, row-reduce epilogue + FDK scale; plus source read
        and sink write when wired), each fenced so that its span is that
        stage's wall time on the card. A traced run trades away the overlap
        the pipelined schedules buy, so it is a MEASUREMENT run, not a
        production configuration. Span names are the fixed ``stage.*``
        vocabulary of `obs.attribution.STAGE_FIELDS`; the output is the
        fused layout (chunked + scatter's y-chunk-major store layout does
        not apply). On a mesh every rank calls it, and each rank's
        un-reduced partial crosses the stage boundary as a plain tensor.

        With the tracer disabled the stages run unfenced; with it enabled,
        every run also deposits its per-stage seconds into the calibration
        store (planner/calibrate.py).

        schedule="incremental" returns a `TracedIncrementalSession`: the
        session's stage()/fold work split into the same vocabulary.
        """
        if self.schedule == "incremental":
            return TracedIncrementalSession(self, source=source, sink=sink)
        self.validate()
        g, mesh = self.geometry, self.mesh
        st = self._make_stages()
        attrs = self._span_attrs()
        # the fused decomposition's inputs: one batch of this rank's column
        # group's P, in the order the AllGather concatenates the columns
        dev, pm_steps, shape, what = dataclasses.replace(
            self, schedule="fused", n_steps=1, y_chunks=None)._engine_inputs()
        pm_col = pm_steps[0]
        spec = None
        if mesh is not None:
            spec = ([AXIS_MODEL, AXIS_DATA] if self.reduce in SCATTER_REDUCES
                    else [AXIS_MODEL])

        def reconstruct_traced(projections=None) -> torch.Tensor:
            tracer = get_tracer()
            seconds: Dict[str, float] = {}
            with tracer.span("engine.traced", **attrs):
                if projections is None:
                    if source is None:
                        raise TypeError(
                            "this traced plan has no ProjectionSource; "
                            "pass the projections array")
                    with tracer.span("stage.read") as sp:
                        projections = sp.fence(
                            source.load(mesh, device=self.device))
                    seconds["stage.read"] = sp.duration_s
                proj = torch.as_tensor(projections, device=dev)
                if tuple(proj.shape) != shape:
                    raise ValueError(
                        f"projections must be {what} = {shape}, "
                        f"got {tuple(proj.shape)}")
                with tracer.span("stage.filter") as sp:
                    cols = sp.fence(st.filter_encode(proj))
                seconds["stage.filter"] = sp.duration_s
                with tracer.span("stage.allgather") as sp:
                    pm_c, q_col, sc_col = sp.fence(
                        st.gather_cols(pm_col, cols)())
                seconds["stage.allgather"] = sp.duration_s
                with tracer.span("stage.backproject") as sp:
                    part = sp.fence(st.backproject(
                        st.slab_pmats(pm_c), q_col, st.nx_slab, g.n_y,
                        g.n_z, scales=sc_col))
                seconds["stage.backproject"] = sp.duration_s
                with tracer.span("stage.reduce") as sp:
                    volume = sp.fence(st.reduce_slab(part) * st.scale)
                seconds["stage.reduce"] = sp.duration_s
                if sink is not None:
                    with tracer.span("stage.write") as sp:
                        sink.write(volume, mesh=mesh, spec=spec)
                    seconds["stage.write"] = sp.duration_s
            if tracer.enabled:
                # a traced run IS a calibration sample: feed the measured
                # stage times back into the planner's store. Disabled
                # tracer: spans are no-ops, there is nothing to record.
                from ..planner.calibrate import record_traced_run
                record_traced_run(self, seconds)
            return volume

        reconstruct_traced.collectives = st.coll
        return reconstruct_traced


class StagedDelta(NamedTuple):
    """One angle subset after the ARRIVAL-side stages — filtered, encoded
    and column-AllGathered, awaiting only its fold. Produced by
    `IncrementalSession.stage`, consumed by `IncrementalSession.update`."""

    lo: int
    hi: int
    pm_col: torch.Tensor            # the column group's P of the delta
    q_col: torch.Tensor             # filtered + encoded columns (wire format)
    sc_col: Optional[torch.Tensor]  # per-projection scales (scaled codecs)


class IncrementalSession:
    """Stateful streaming reconstruction — `plan.build_incremental()`.

    State machine::

        OPEN --update(delta, angles)--> OPEN    fold one angle subset
        OPEN --poll()-----------------> OPEN    discover + fold source deltas
        OPEN --finalize(partial=True)-> OPEN    peek: reduce a COPY of state
        OPEN --finalize()-------------> OPEN    full volume (all angles seen)

    `finalize` is pure — the resident accumulator is never consumed, so the
    session can keep folding after a peek. Each `update` filters, encodes
    and column-AllGathers ONE contiguous angle slice and folds it into
    this rank's slab accumulator; `finalize` runs only the row-reduce
    epilogue and the FDK scale.

    Resident state (per rank): the f32 slab accumulator — (N_x/R, N_y,
    N_z) under reduce="psum" (row-reduce deferred to finalize), or already
    scattered, (N_x/R, N_y/C_data, N_z), under the scatter reduces (each
    update reduce-scatters its partial, so the state stays bounded). For
    "scatter_bf16" an f32 error-feedback carry of the full-width slab
    rides along: the rounding residual each update drops is re-injected
    into the next update's partial, so only the final update's rounding
    survives per rank.

    On a mesh, every rank calls each method, `update` with its own share
    of the delta: the rows `local_projections(delta, mesh)` gives it
    (`ProjectionSource.iter_deltas(mesh)` reads exactly those).

    Exactness contract: with impl="reference"/"factorized" the fold
    threads the accumulator INTO the back-projection (`init=`), continuing
    the per-voxel addition sequence — so folding deltas in order is
    bit-identical to the fused engine (psum, same rank count), and folding
    any permutation is bit-identical to the fused engine fed that same
    permuted projection stream. impl="kernel" folds `acc + bp(delta)` (the
    kernel owns its accumulator) and matches to f32 reassociation
    tolerance.
    """

    def __init__(self, plan: ReconstructionPlan, source=None, sink=None):
        plan.validate()
        self.plan = plan
        self._source = source
        self._sink = sink
        st = self._stages = plan._make_stages()
        self._scatter = plan.reduce in SCATTER_REDUCES
        self._compensated = plan.reduce == "scatter_bf16"
        # reference/factorized thread the accumulator INTO the loop
        # (`init=`) for the bit-exact fold; the kernel owns its
        # accumulator, so it folds `acc + bp(delta)`.
        self._threads_init = plan.impl in ("reference", "factorized")
        g = plan.geometry
        dev = resolve_device(plan.device)
        self._covered = np.zeros(g.n_proj, dtype=bool)
        self._pmats = torch.as_tensor(projection_matrices(g), device=dev)
        ny = g.n_y // plan._data_size if self._scatter else g.n_y
        self._acc = torch.zeros((st.nx_slab, ny, g.n_z), dtype=torch.float32,
                                device=dev)
        self._carry = (torch.zeros((st.nx_slab, g.n_y, g.n_z),
                                   dtype=torch.float32, device=dev)
                       if self._compensated else None)

    # -- bookkeeping --------------------------------------------------------

    @property
    def n_folded(self) -> int:
        """Angles folded so far."""
        return int(self._covered.sum())

    @property
    def is_complete(self) -> bool:
        return bool(self._covered.all())

    def pending_ranges(self) -> list:
        """Contiguous [lo, hi) angle ranges not folded yet."""
        missing = ~self._covered
        (idx,) = np.nonzero(np.diff(missing.astype(np.int8), prepend=0,
                                    append=0))
        return [(int(idx[i]), int(idx[i + 1]))
                for i in range(0, len(idx), 2)]

    def _check_slice(self, angle_slice) -> Tuple[int, int]:
        if isinstance(angle_slice, slice):
            if angle_slice.step not in (None, 1):
                raise ValueError("angle_slice must be contiguous (step 1)")
            lo, hi = angle_slice.start or 0, angle_slice.stop
        else:
            lo, hi = angle_slice
        n_proj = self.plan.geometry.n_proj
        if hi is None:
            hi = n_proj
        lo, hi = int(lo), int(hi)
        if not (0 <= lo < hi <= n_proj):
            raise ValueError(
                f"angle_slice [{lo}, {hi}) out of range for N_p={n_proj}")
        if self._covered[lo:hi].any():
            raise ValueError(
                f"angle_slice [{lo}, {hi}) overlaps angles already folded "
                "into this session — double-folding corrupts the volume")
        n_ranks = self.plan.grid.n_ranks
        if (hi - lo) % n_ranks:
            raise ValueError(
                f"delta of {hi - lo} angles must divide over the "
                f"{n_ranks} ranks of the grid")
        return lo, hi

    def _check_delta_shape(self, delta, lo: int, hi: int) -> None:
        g = self.plan.geometry
        n = (hi - lo) // self.plan.grid.n_ranks
        if tuple(delta.shape) != (n, g.n_v, g.n_u):
            share = "" if self.plan.mesh is None else "this rank's share of "
            raise ValueError(
                f"projection_delta shape {tuple(delta.shape)} does not "
                f"match {share}angles [{lo}, {hi}) x detector "
                f"({g.n_v}, {g.n_u})")

    # -- the fold (one delta) -----------------------------------------------

    def _delta_inputs(self, delta, lo: int, hi: int):
        """(the column group's P, the raw delta on the device) for this
        rank's share of angles [lo, hi)."""
        mesh = self.plan.mesh
        pm = self._pmats[lo:hi]
        pm_col = pm if mesh is None else column_pmats(pm, mesh, 1)[0]
        return pm_col, torch.as_tensor(delta, device=self._pmats.device)

    def _columns(self, delta, lo: int, hi: int):
        """Filter + encode + column AllGather of this rank's share of the
        raw delta for angles [lo, hi): (pm_col, q_col, sc_col)."""
        return self._stages.gather_batch(*self._delta_inputs(delta, lo, hi))()

    def _fold(self, pm_col, q_col, sc_col) -> None:
        st, g = self._stages, self.plan.geometry
        pm_s = st.slab_pmats(pm_col)
        if not self._scatter:
            if self._threads_init:
                self._acc = st.backproject(pm_s, q_col, st.nx_slab, g.n_y,
                                           g.n_z, scales=sc_col,
                                           init=self._acc)
            else:
                self._acc = self._acc + st.backproject(
                    pm_s, q_col, st.nx_slab, g.n_y, g.n_z, scales=sc_col)
            return
        self._accumulate(st.backproject(pm_s, q_col, st.nx_slab, g.n_y,
                                        g.n_z, scales=sc_col))

    def _accumulate(self, part) -> None:
        """The scatter reduces' per-delta reduce of a partial slab into the
        (scattered) resident accumulator."""
        st = self._stages
        if self._compensated:
            # error feedback along the time axis: the carry is the residual
            # of the PREVIOUS delta's rounding
            red, self._carry = st.scatter_compensated(part, self._carry)
        else:
            red = st.coll.reduce_scatter_y(part, st.data_axis)
        self._acc = self._acc + red

    def _epilogue(self) -> torch.Tensor:
        """Row-reduce epilogue + FDK scale of a COPY of the accumulator:
        psum over the data-parallel axes (under psum), the cross-pod
        finish (under the scatter reduces, which reduced over `data` per
        update)."""
        st = self._stages
        slab = self._acc
        if st.coll is None:
            axes = ()
        elif self._scatter:
            axes = (st.pod_axis,) if st.pod_axis is not None else ()
        else:
            axes = st.dp
        if axes:
            slab = slab.clone()
        for a in axes:
            slab = st.coll.all_reduce(slab, a)
        return slab * st.scale

    def _store(self, volume) -> None:
        wait_for(volume)
        with get_tracer().span("stage.write"):
            self._sink.write(volume, mesh=self.plan.mesh,
                             spec=self.plan.output_spec())

    def stage(self, projection_delta, angle_slice) -> StagedDelta:
        """Run the ARRIVAL-side half of an update — filter + encode + column
        AllGather — without folding. Pure (no session state changes).

        Filtering is per-projection independent, so a streaming rank
        stages frames while the burst is still landing: by the time the
        burst's last frame commits, only the fold (back-projection +
        reduce) is left — `update(staged, finalize=True)` is then the
        entire time-from-last-projection tail."""
        lo, hi = self._check_slice(angle_slice)
        self._check_delta_shape(projection_delta, lo, hi)
        with get_tracer().span("session.stage", lo=lo, hi=hi) as sp:
            pm_col, q_col, sc_col = sp.fence(
                self._columns(projection_delta, lo, hi))
        return StagedDelta(lo, hi, pm_col, q_col, sc_col)

    def update(self, projection_delta, angle_slice=None,
               finalize: bool = False):
        """Fold one contiguous angle subset: filter + encode + column
        AllGather + slab back-projection (+ per-delta scatter reduce).

        projection_delta : this rank's share of the raw projections of the
                           global angle range `angle_slice` = slice/
                           (lo, hi) — all (hi - lo, N_v, N_u) of them
                           without a mesh; hi - lo must divide over the
                           rank grid — or a `StagedDelta` from `stage()`
                           (no angle_slice; only the fold runs).
        finalize         : True also runs the reduce epilogue + FDK scale
                           and returns the volume (the time-from-last-delta
                           path). State is still folded, and a
                           full-coverage finalize stores to the session's
                           VolumeSink exactly like finalize().

        Returns the session (chaining) — or the volume when finalize=True.
        """
        staged = isinstance(projection_delta, StagedDelta)
        if staged:
            if angle_slice is not None:
                raise TypeError(
                    "a StagedDelta carries its own angle range; do not "
                    "pass angle_slice")
            s = projection_delta
            lo, hi = self._check_slice((s.lo, s.hi))
        else:
            if angle_slice is None:
                raise TypeError("angle_slice is required for a raw delta")
            lo, hi = self._check_slice(angle_slice)
            self._check_delta_shape(projection_delta, lo, hi)
        volume = None
        with get_tracer().span("session.fold", lo=lo, hi=hi, staged=staged,
                               final=finalize) as sp:
            cols = ((s.pm_col, s.q_col, s.sc_col) if staged
                    else self._columns(projection_delta, lo, hi))
            self._fold(*cols)
            if finalize:
                volume = self._epilogue()
            sp.fence(volume if finalize else self._acc)
        self._covered[lo:hi] = True
        if not finalize:
            return self
        if self._sink is not None and self.is_complete:
            self._store(volume)
        return volume

    # -- source coupling ----------------------------------------------------

    def poll(self) -> int:
        """Discover newly landed deltas on the ProjectionSource and fold
        them. Returns the number of deltas folded (0 = nothing new)."""
        if self._source is None:
            raise TypeError(
                "session was built without a ProjectionSource; feed deltas "
                "via update(delta, angle_slice) instead")
        n = 0
        with get_tracer().span("session.poll") as sp:
            for lo, hi, delta in self._source.iter_deltas(
                    self.plan.mesh, device=self.plan.device):
                self.update(delta, (lo, hi))
                n += 1
            sp.set(n_deltas=n)
        return n

    # -- epilogue -----------------------------------------------------------

    def finalize(self, partial: bool = False) -> torch.Tensor:
        """Row-reduce epilogue + FDK scale — the ONLY work left after the
        last delta folds. Pure: the session keeps accepting updates.

        partial=True returns the reconstruction from the angles folded so
        far (a mid-scan peek). The default demands full coverage. A full
        finalize stores the volume to the session's VolumeSink, if one
        was given. Returns this rank's part of the volume, in build()'s
        output layout.
        """
        if not partial and not self.is_complete:
            raise ValueError(
                f"only {self.n_folded}/{self.plan.geometry.n_proj} angles "
                f"folded; missing ranges {self.pending_ranges()} — fold "
                "them (update/poll) or pass partial=True for a mid-scan "
                "peek")
        with get_tracer().span("session.finalize", partial=partial) as sp:
            volume = sp.fence(self._epilogue())
        if self._sink is not None and not partial:
            self._store(volume)
        return volume


class TracedIncrementalSession(IncrementalSession):
    """The streaming session cut at its stage seams: `build_traced` for
    schedule="incremental".

    Same state machine and exactness contract as `IncrementalSession`, but
    its work runs in fenced ``stage.*`` spans (the `STAGE_FIELDS`
    vocabulary): stage() emits ``stage.filter`` + ``stage.allgather``; a
    fold emits ``stage.backproject`` and, under the scatter reduces (each
    delta reduce-scatters its partial), ``stage.reduce``; the finalize
    epilogue is a ``stage.reduce`` span too (psum's one deferred reduce).
    Raw deltas are routed through stage() first, so the raw-update path
    decomposes the same way.

    A MEASUREMENT configuration: the spans are `timed=True`, so stage
    seconds accumulate (`stage_seconds()`) even with the tracer disabled.
    On the first full-coverage volume (finalize, or `update(...,
    finalize=True)`) they are deposited into the calibration store
    (planner/calibrate.py) against the plan's incremental cost point.
    """

    def __init__(self, plan: ReconstructionPlan, source=None, sink=None):
        super().__init__(plan, source=source, sink=sink)
        self._stage_seconds: Dict[str, float] = {}
        self._recorded = False

    def stage_seconds(self) -> Dict[str, float]:
        """Accumulated per-stage wall seconds so far (a copy)."""
        return dict(self._stage_seconds)

    def _timed(self, name: str, fn, *args):
        """fn(*args) in a fenced, timed span `name`, its seconds added."""
        with get_tracer().span(name, timed=True) as sp:
            out = sp.fence(fn(*args))
        self._stage_seconds[name] = (self._stage_seconds.get(name, 0.0)
                                     + sp.duration_s)
        return out

    # -- stage decomposition -------------------------------------------------

    def _columns(self, delta, lo: int, hi: int):
        st = self._stages
        pm_col, raw = self._delta_inputs(delta, lo, hi)
        cols = self._timed("stage.filter", st.filter_encode, raw)
        return self._timed("stage.allgather",
                           lambda: st.gather_cols(pm_col, cols)())

    def _fold(self, pm_col, q_col, sc_col) -> None:
        if not self._scatter:
            # psum: the fold IS the back-projection; the row reduce is
            # deferred to the epilogue
            def fold():
                IncrementalSession._fold(self, pm_col, q_col, sc_col)
                return self._acc
            self._timed("stage.backproject", fold)
            return
        st, g = self._stages, self.plan.geometry
        part = self._timed(
            "stage.backproject", st.backproject, st.slab_pmats(pm_col),
            q_col, st.nx_slab, g.n_y, g.n_z, sc_col)

        def reduce():
            self._accumulate(part)
            return self._acc
        self._timed("stage.reduce", reduce)

    def _epilogue(self) -> torch.Tensor:
        return self._timed("stage.reduce", super()._epilogue)

    # -- calibration feedback ------------------------------------------------

    def update(self, projection_delta, angle_slice=None,
               finalize: bool = False):
        if not isinstance(projection_delta, StagedDelta):
            if angle_slice is None:
                raise TypeError("angle_slice is required for a raw delta")
            projection_delta = self.stage(projection_delta, angle_slice)
            angle_slice = None
        out = super().update(projection_delta, angle_slice,
                             finalize=finalize)
        if finalize and self.is_complete:
            self._record_calibration()
        return out

    def finalize(self, partial: bool = False) -> torch.Tensor:
        volume = super().finalize(partial=partial)
        if not partial:
            self._record_calibration()
        return volume

    def _record_calibration(self) -> None:
        if self._recorded:
            return
        self._recorded = True
        from ..planner.calibrate import record_traced_run
        record_traced_run(self.plan, dict(self._stage_seconds))


# ---------------------------------------------------------------------------
# Carrying a reference plan across
# ---------------------------------------------------------------------------

_GEOMETRY_FIELDS = tuple(f.name for f in dataclasses.fields(CBCTGeometry))
_PLAN_FIELDS = ("impl", "window", "precision", "schedule", "n_steps",
                "y_chunks", "reduce")


def plan_from_reference(fields: dict, device="cuda",
                        mesh: Optional[DeviceMesh] = None
                        ) -> ReconstructionPlan:
    """The port's plan for the plain fields of a reference plan.

    `fields` is either ``dataclasses.asdict`` of a reference `CBCTGeometry`
    (the 13 geometry fields; every other plan field takes its default) or
    the plain fields of a reference `ReconstructionPlan` — ``geometry`` (a
    dict or an object with the geometry fields), ``mesh``, ``impl``,
    ``window``, ``precision`` (a name, or ``{"storage": name}`` as
    ``asdict`` gives it), ``schedule``, ``n_steps``, ``y_chunks`` and
    ``reduce``. A reference mesh is carried across as `mesh`, the port's
    mesh, which must have the same axis names and shape; a mesh on one side
    only raises ValueError. A pinned ``blocks``/``vmem_budget`` raises
    ValueError: the reference's Pallas tile and VMEM budget do not carry
    over to the card's kernel, whose launch shape the port's tuner picks.
    """
    if "geometry" not in fields:
        return ReconstructionPlan(geometry=_geometry_from(fields),
                                  mesh=mesh, device=device)
    ref_mesh = fields.get("mesh")
    if _mesh_layout(ref_mesh) != _mesh_layout(mesh):
        raise ValueError(
            f"the reference plan's mesh {_mesh_layout(ref_mesh)} (axis "
            f"names, shape) is not the port's mesh {_mesh_layout(mesh)}; "
            "pass mesh=make_mesh(shape, axes) with the same layout")
    for key in ("blocks", "vmem_budget"):
        if fields.get(key) is not None:
            raise ValueError(
                f"the reference plan pins {key}={fields[key]!r}: a Pallas "
                "tile or VMEM budget does not carry over to the card, where "
                "the kernel's launch shape is a Hopper tile and a per-block "
                "shared-memory budget; drop it to let the port's tuner "
                "pick, or set the port plan's blocks/vmem_budget")
    unknown = set(fields) - set(_PLAN_FIELDS) - {
        "geometry", "mesh", "blocks", "vmem_budget"}
    if unknown:
        raise ValueError(f"unknown reference plan fields {sorted(unknown)}")
    kwargs = {k: fields[k] for k in _PLAN_FIELDS if k in fields}
    prec = kwargs.get("precision")
    if isinstance(prec, dict):
        kwargs["precision"] = prec["storage"]
    elif prec is not None and not isinstance(prec, str):
        kwargs["precision"] = prec.storage
    return ReconstructionPlan(geometry=_geometry_from(fields["geometry"]),
                              mesh=mesh, device=device, **kwargs)


def _mesh_layout(mesh):
    """(axis names, shape) of a reference (JAX) or port mesh, or None."""
    if mesh is None:
        return None
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    devices = getattr(mesh, "devices", None)
    return (tuple(getattr(mesh, "axis_names", ())),
            tuple(getattr(devices, "shape", ())))


def _geometry_from(g) -> CBCTGeometry:
    if not isinstance(g, dict):
        g = {name: getattr(g, name) for name in _GEOMETRY_FIELDS}
    if set(g) != set(_GEOMETRY_FIELDS):
        raise ValueError(
            f"geometry fields {sorted(g)} are not the CBCTGeometry fields "
            f"{sorted(_GEOMETRY_FIELDS)}")
    return CBCTGeometry(**g)


# ---------------------------------------------------------------------------
# Spec strings
# ---------------------------------------------------------------------------

_SPEC_INT_KEYS = ("n_steps", "y_chunks", "vmem_budget")
_SPEC_STR_KEYS = ("impl", "window", "precision", "schedule", "reduce")
_SPEC_KEYS = _SPEC_STR_KEYS + _SPEC_INT_KEYS + ("blocks",)

_SPEC_VALUE_KEYS = {
    **{v: "schedule" for v in _SCHEDULES},
    **{v: "reduce" for v in _REDUCES},
    **{v: "impl" for v in _IMPLS},
    **{v: "precision" for v in _PRECISIONS},
    **{v: "window" for v in _WINDOWS},
}


def _spec_hint(token: str) -> str:
    """'; did you mean ...?' for the nearest valid spec token, or ''."""
    candidates = ["auto"] + list(_SPEC_KEYS) + list(_SPEC_VALUE_KEYS)
    close = difflib.get_close_matches(token, candidates, n=1, cutoff=0.6)
    if not close:
        return ""
    match = close[0]
    if match in _SPEC_VALUE_KEYS:
        match = f"{_SPEC_VALUE_KEYS[match]}={match}"
    elif match in _SPEC_KEYS:
        match = f"{match}=..."
    return f"; did you mean {match!r}?"


def plan_from_spec(geometry: CBCTGeometry, spec: str = "",
                   mesh=None, **overrides) -> ReconstructionPlan:
    """Build a plan from a compact ``key=value,key=value`` spec string
    (e.g. ``"schedule=pipelined,n_steps=4,precision=bf16"``).

    Recognized keys: impl, window, precision, schedule, n_steps, y_chunks,
    reduce, vmem_budget (the per-block shared-memory budget in bytes) and
    blocks (the kernel's tile, as ``ti:tj:tk``) — the reference's keys, so
    one spec string parses in both packages. ``overrides`` kwargs
    (``device`` among them) win over the spec string.

    The bare token ``auto`` hands the remaining (pinned) dimensions to the
    planner (planner/search.py): ``"auto"`` searches the whole space for
    the best feasible plan on this (geometry, mesh, device);
    ``"auto,precision=bf16"`` searches with the precision axis pinned.
    """
    kwargs: dict = {}
    auto = False
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            if item == "auto":
                auto = True
                continue
            raise ValueError(
                f"plan spec token {item!r} is not key=value and not 'auto'; "
                f"valid keys: {', '.join(_SPEC_KEYS)}{_spec_hint(item)}")
        key, val = (s.strip() for s in item.split("=", 1))
        if key in _SPEC_INT_KEYS:
            kwargs[key] = int(val)
        elif key == "blocks":
            kwargs[key] = tuple(int(v) for v in val.split(":"))
        elif key in _SPEC_STR_KEYS:
            kwargs[key] = val
        else:
            raise ValueError(
                f"unknown plan spec key {key!r}; valid keys: "
                f"{', '.join(_SPEC_KEYS)}{_spec_hint(key)}")
    kwargs.update(overrides)
    if auto:
        from ..planner import auto_plan
        window = kwargs.pop("window", "ramlak")
        vmem_budget = kwargs.pop("vmem_budget", None)
        device = kwargs.pop("device", "cuda")
        return auto_plan(geometry, mesh=mesh, window=window,
                         vmem_budget=vmem_budget, device=device, **kwargs)
    return ReconstructionPlan(geometry=geometry, mesh=mesh, **kwargs)
