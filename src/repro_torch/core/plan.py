"""Declarative reconstruction plans + the staged engine, single device.

Port of the `mesh=None` part of `repro/core/plan.py`:

    plan = ReconstructionPlan(geometry=g, impl="kernel", precision="fp16")
    fdk = plan.build()          # validated, cached per plan
    volume = fdk(projections)   # (N_p, N_v, N_u) -> (N_x, N_y, N_z) f32

A `ReconstructionPlan` is a frozen dataclass capturing every degree of
freedom of the pipeline; `validate()` centralizes the feasibility checks
and `build()` composes the stage primitives

    filter + encode      make_filter(window) then the precision's codec
    back-projection      the impl ("reference" | "factorized" | "kernel")
    y-chunk offsets      shift_pmats_j (chunked schedule)
    fdk_scale            once at the end

into one function for the fused, pipelined and chunked schedules. The
plan's `device` (default "cuda") says where everything runs; asking for
the card on a host without one raises and names ``device="cpu"``.

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): a `mesh`, `build_batched`, `build_incremental`, `build_traced`,
`source=`/`sink=`, `schedule="incremental"` and `plan_from_spec("auto")`.
The reference's `blocks`/`vmem_budget` fields return with the Hopper
launch-shape tuner.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Literal, Optional

import torch

from ..device import resolve_device
from .cache import CountingLRU
from .distributed import IFDKGrid
from .fdk import BpImpl, _get_backprojector, fdk_scale
from .filtering import _WINDOWS, make_filter
from .geometry import CBCTGeometry, projection_matrices
from .precision import Precision, resolve_precision

Schedule = Literal["fused", "pipelined", "chunked", "incremental"]

_SCHEDULES = ("fused", "pipelined", "chunked", "incremental")
_REDUCES = ("psum", "scatter", "scatter_bf16")
_IMPLS = ("reference", "factorized", "kernel")
_PRECISIONS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")

# ROADMAP.md Queue 1 items that bring back what this slice leaves out.
_TUNER = "ROADMAP.md Queue 1 item 7 (Hopper launch-shape tuner, tune.py)"
_MESH = "ROADMAP.md Queue 1 item 9 (mesh engine)"
_ENGINES = ("ROADMAP.md Queue 1 item 10 (batched, incremental and traced "
            "engines)")
_IO_PLANNER = ("ROADMAP.md Queue 1 item 11 (I/O, planner, observability, "
               "service)")

# build() results keyed by the (hashable) plan: repeated builds of the same
# plan reuse the engine.
_ENGINE_CACHE = CountingLRU(capacity=64)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {item}")


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()


def engine_cache_stats() -> dict:
    """hit/miss/eviction/unhashable counters of the shared engine cache."""
    return _ENGINE_CACHE.stats()


def shift_pmats_j(pmats: torch.Tensor, j0) -> torch.Tensor:
    """Reparameterize P for a y-chunk starting at voxel index j0:
    P'[:, 3] = P[:, 3] + j0 * P[:, 1]."""
    out = pmats.clone()
    out[..., :, 3] += pmats[..., :, 1] * j0
    return out


@dataclasses.dataclass
class _Stages:
    """The engine's stage primitives, composed once per plan."""

    filter_encode: Callable  # raw_b -> (data_b, scales_b)
    backproject: Callable    # resolved impl
    scale: float             # fdk_scale(geometry)


@dataclasses.dataclass(frozen=True)
class ReconstructionPlan:
    """Everything that determines a reconstruction, in one declarative value.

    Fields
    ------
    geometry   : the CBCT scan geometry (paper Table 1).
    mesh       : must be None (single device); the mesh engine is not
                 ported yet.
    impl       : back-projection implementation ("reference" | "factorized"
                 | "kernel" — the hand-written CUDA kernel on the card).
    window     : ramp-filter apodization window.
    precision  : storage codec of the filtered-projection stream: a
                 Precision, a name, or None for the device's default (fp16
                 on the card, bf16 on the CPU). Accumulation is always f32.
    schedule   : "fused" — one filter+encode, one back-projection;
                 "pipelined" — `n_steps` projection micro-batches, each
                 filtered, encoded and back-projected into one accumulator;
                 "chunked" — pipelined, back-projecting `y_chunks` y-chunks
                 of the volume per micro-batch.
    n_steps    : projection micro-batches (pipelined/chunked).
    y_chunks   : y-axis chunks (chunked only).
    reduce     : row-reduce epilogue; only "psum" (a no-op) applies
                 without a mesh.
    device     : where the plan runs, default "cuda".
    """

    geometry: CBCTGeometry
    mesh: None = None
    impl: BpImpl = "factorized"
    window: str = "ramlak"
    precision: Precision | str | None = "fp32"
    schedule: Schedule = "fused"
    n_steps: int = 1
    y_chunks: Optional[int] = None
    reduce: str = "psum"
    device: str = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise _not_ported("ReconstructionPlan(mesh=...)", _MESH)
        resolve_device(self.device)

    @property
    def grid(self) -> IFDKGrid:
        """The paper's R (slabs) x C (projection groups) rank grid."""
        return IFDKGrid(r=1, c=1)

    def resolved_precision(self) -> Precision:
        return resolve_precision(self.precision, self.device)

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
        if self.n_steps < 1:
            raise ValueError(f"n_steps={self.n_steps} must be >= 1")
        if self.schedule == "fused" and self.n_steps != 1:
            raise ValueError(
                "the fused schedule has no micro-batching; use "
                "schedule='pipelined' (or 'chunked') for n_steps > 1")
        if g.n_proj % self.n_steps:
            raise ValueError(
                f"per-rank N_p={g.n_proj} must divide into "
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
        if self.reduce != "psum":
            raise ValueError(
                f"reduce={self.reduce!r} needs a mesh with a 'data' "
                "axis to scatter over; use reduce='psum' on a single "
                "device")
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

    # -- engine -------------------------------------------------------------

    def _make_stages(self) -> _Stages:
        g = self.geometry
        codec = self.resolved_precision().codec
        # The filter emits f32; the stream codec owns the quantization to
        # the wire format.
        filt = make_filter(g, self.window, out_dtype=torch.float32,
                           device=self.device)

        def filter_encode(raw_b: torch.Tensor):
            return codec.encode(filt(raw_b))

        return _Stages(filter_encode=filter_encode,
                       backproject=_get_backprojector(self.impl),
                       scale=fdk_scale(g))

    def _build_rank_fn(self) -> Callable:
        """Compose the stage primitives into rank_fn(pmats, projections)."""
        g = self.geometry
        st = self._make_stages()
        filter_encode, backproject, scale = (
            st.filter_encode, st.backproject, st.scale)
        n_steps = self.n_steps
        nb = g.n_proj // n_steps

        def steps(pm, proj):
            """Per micro-batch: (P, wire data, scales)."""
            for s in range(n_steps):
                sl = slice(s * nb, (s + 1) * nb)
                yield (pm[sl],) + tuple(filter_encode(proj[sl]))

        if self.schedule == "fused":
            def fused(pm, proj):
                data, sc = filter_encode(proj)
                return backproject(pm, data, g.n_x, g.n_y, g.n_z,
                                   scales=sc) * scale
            return fused

        if self.schedule == "pipelined":
            def pipelined(pm, proj):
                acc = torch.zeros((g.n_x, g.n_y, g.n_z), dtype=torch.float32,
                                  device=proj.device)
                for pm_b, data, sc in steps(pm, proj):
                    acc = acc + backproject(pm_b, data, g.n_x, g.n_y, g.n_z,
                                            scales=sc)
                return acc * scale
            return pipelined

        # chunked: per-y-chunk back-projection, bounding the live slab state
        y_chunks = self.y_chunks
        yc = g.n_y // y_chunks

        def chunked(pm, proj):
            acc = torch.zeros((g.n_x, y_chunks, yc, g.n_z),
                              dtype=torch.float32, device=proj.device)
            for pm_b, data, sc in steps(pm, proj):
                for ci in range(y_chunks):
                    part = backproject(shift_pmats_j(pm_b, float(ci * yc)),
                                       data, g.n_x, yc, g.n_z, scales=sc)
                    acc[:, ci] = acc[:, ci] + part
            return acc.reshape(g.n_x, g.n_y, g.n_z) * scale
        return chunked

    def build(self, source=None, sink=None) -> Callable:
        """Validated reconstruction on the plan's device: projections
        (N_p, N_v, N_u) -> volume (N_x, N_y, N_z) f32. Projections may be a
        tensor or an array; they are placed on the plan's device.
        Results are cached per plan."""
        if self.schedule == "incremental":
            raise _not_ported("schedule='incremental'", _ENGINES)
        if source is not None or sink is not None:
            raise _not_ported("build(source=, sink=)", _IO_PLANNER)
        cached = _ENGINE_CACHE.get(self)
        if cached is not None:
            return cached
        self.validate()
        g = self.geometry
        dev = resolve_device(self.device)
        rank_fn = self._build_rank_fn()
        pmats_all = torch.as_tensor(projection_matrices(g), device=dev)

        def reconstruct_fn(projections) -> torch.Tensor:
            proj = torch.as_tensor(projections, device=dev)
            if tuple(proj.shape) != g.proj_shape():
                raise ValueError(
                    f"projections must be (N_p, N_v, N_u) = {g.proj_shape()}, "
                    f"got {tuple(proj.shape)}")
            return rank_fn(pmats_all, proj)

        _ENGINE_CACHE.put(self, reconstruct_fn)
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


def plan_from_reference(fields: dict, device="cuda") -> ReconstructionPlan:
    """The port's plan for the plain fields of a reference plan.

    `fields` is either ``dataclasses.asdict`` of a reference `CBCTGeometry`
    (the 13 geometry fields; every other plan field takes its default) or
    the plain fields of a reference `ReconstructionPlan` — ``geometry`` (a
    dict or an object with the geometry fields), ``impl``, ``window``,
    ``precision`` (a name, or ``{"storage": name}`` as ``asdict`` gives
    it), ``schedule``, ``n_steps``, ``y_chunks`` and ``reduce``. A mesh, or
    a pinned ``blocks``/``vmem_budget``, raises NotImplementedError.
    """
    if "geometry" not in fields:
        return ReconstructionPlan(geometry=_geometry_from(fields),
                                  device=device)
    if fields.get("mesh") is not None:
        raise _not_ported("a reference plan with a mesh", _MESH)
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
                              device=device, **kwargs)


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
