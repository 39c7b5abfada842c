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

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): `build_batched`, `build_incremental`, `build_traced`,
`source=`/`sink=`, `schedule="incremental"` and `plan_from_spec("auto")`.
The reference's `blocks`/`vmem_budget` fields return with the Hopper
launch-shape tuner.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Literal, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
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

# ROADMAP.md Queue 1 items that bring back what this slice leaves out.
_TUNER = "ROADMAP.md Queue 1 item 7 (Hopper launch-shape tuner, tune.py)"
_ENGINES = ("ROADMAP.md Queue 1 item 10 (batched, incremental and traced "
            "engines)")
_IO_PLANNER = ("ROADMAP.md Queue 1 item 11 (I/O, planner, observability, "
               "service)")

# build() results keyed by the (hashable) plan and, on a mesh, the mesh's
# process groups (a new group behind an equal mesh is a new engine).
_ENGINE_CACHE = CountingLRU(capacity=64)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {item}")


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()


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
    slab_pmats: Callable     # pm_col -> P shifted to this rank's x-slab
    reduce_slab: Callable    # full-slab row-reduce epilogue
    backproject: Callable    # resolved impl
    nx_slab: int
    scale: float             # fdk_scale(geometry)
    coll: Optional[Collectives]
    dp: Tuple[str, ...]      # row-reduce axes present on the mesh


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
        if self.impl == "kernel" and g.n_z % 2:
            raise ValueError(
                f"impl='kernel' requires even N_z (dual-slab layout), "
                f"got N_z={g.n_z}")
        return self

    def describe(self) -> dict:
        """Flat summary of the resolved plan (benchmark/report labels)."""
        grid = self.grid
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
        def gather_batch(pm_col, raw_b, async_op=False):
            cols = tuple(codec.encode(filt(raw_b)))
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

        return _Stages(gather_batch=gather_batch, slab_pmats=slab_pmats,
                       reduce_slab=reduce_slab,
                       backproject=_get_backprojector(self.impl),
                       nx_slab=nx_slab, scale=fdk_scale(g), coll=coll, dp=dp)

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
        data_axis = AXIS_DATA if AXIS_DATA in st.dp else None
        pod_axis = AXIS_POD if AXIS_POD in st.dp else None

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
                        # error feedback: re-inject the residual this rank
                        # dropped when it rounded the SAME chunk last
                        # round, so rounding error does not accumulate
                        # over the n_steps micro-batches — only the final
                        # round's rounding survives (one per rank).
                        part = part + err[:, ci]
                        half = part.to(torch.bfloat16)
                        err[:, ci] = part - half.to(torch.float32)
                        red = coll.reduce_scatter_y(half, data_axis).to(
                            torch.float32)
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
        """
        if self.schedule == "incremental":
            raise _not_ported("schedule='incremental'", _ENGINES)
        if source is not None or sink is not None:
            raise _not_ported("build(source=, sink=)", _IO_PLANNER)
        key = (self if self.mesh is None
               else (self, tuple(self.mesh.get_all_groups())))
        cached = _ENGINE_CACHE.get(key)
        if cached is not None:
            return cached
        self.validate()
        g = self.geometry
        dev = resolve_device(self.device)
        st = self._make_stages()
        rank_fn = self._build_rank_fn(st)
        pm = torch.as_tensor(projection_matrices(g), device=dev)
        shape = g.proj_shape()
        what = "(N_p, N_v, N_u)"
        if self.mesh is None:
            pm_steps = pm.reshape((self.n_steps, -1) + pm.shape[1:])
        else:
            pm_steps = column_pmats(pm, self.mesh, self.n_steps)
            shape = (g.n_proj // self.grid.n_ranks,) + shape[1:]
            what = "this rank's (N_p/(R*C), N_v, N_u)"

        def reconstruct_fn(projections) -> torch.Tensor:
            proj = torch.as_tensor(projections, device=dev)
            if tuple(proj.shape) != shape:
                raise ValueError(
                    f"projections must be {what} = {shape}, "
                    f"got {tuple(proj.shape)}")
            return rank_fn(pm_steps, proj)

        reconstruct_fn.collectives = st.coll
        _ENGINE_CACHE.put(key, reconstruct_fn)
        return reconstruct_fn

    def build_batched(self, batch_size: int):
        raise _not_ported("build_batched", _ENGINES)

    def build_incremental(self, source=None, sink=None):
        raise _not_ported("build_incremental", _ENGINES)

    def build_traced(self, source=None, sink=None):
        raise _not_ported("build_traced", _ENGINES)


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
    NotImplementedError.
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
            raise _not_ported(f"a pinned {key}", _TUNER)
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

_SPEC_INT_KEYS = ("n_steps", "y_chunks")
_SPEC_STR_KEYS = ("impl", "window", "precision", "schedule", "reduce")
_SPEC_KEYS = _SPEC_STR_KEYS + _SPEC_INT_KEYS

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
    reduce. ``overrides`` kwargs (``device`` among them) win over the spec
    string. The
    reference's ``blocks``/``vmem_budget`` keys and its ``auto`` token (the
    planner) raise NotImplementedError.
    """
    kwargs: dict = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            if item == "auto":
                raise _not_ported("plan_from_spec('auto')", _IO_PLANNER)
            raise ValueError(
                f"plan spec token {item!r} is not key=value and not 'auto'; "
                f"valid keys: {', '.join(_SPEC_KEYS)}{_spec_hint(item)}")
        key, val = (s.strip() for s in item.split("=", 1))
        if key in _SPEC_INT_KEYS:
            kwargs[key] = int(val)
        elif key in _SPEC_STR_KEYS:
            kwargs[key] = val
        elif key in ("blocks", "vmem_budget"):
            raise _not_ported(f"plan spec key {key!r}", _TUNER)
        else:
            raise ValueError(
                f"unknown plan spec key {key!r}; valid keys: "
                f"{', '.join(_SPEC_KEYS)}{_spec_hint(key)}")
    kwargs.update(overrides)
    return ReconstructionPlan(geometry=geometry, mesh=mesh, **kwargs)
