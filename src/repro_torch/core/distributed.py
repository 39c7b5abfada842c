"""iFDK distributed decomposition (paper §4) over torch.distributed.

Port of `repro/core/distributed.py`. Paper mapping, as in the reference:

  * C (columns, projection groups)  -> mesh axes ("pod", "data")
  * R (rows, volume slabs)          -> mesh axis "model"

Per rank (paper Fig. 3): load + filter N_p/(C*R) projections; **AllGather**
the filtered projections along the column (the `model` axis) so the whole
column group holds its N_p/C subset; back-project the rank's x-slab;
**Reduce** partial slabs along the row (the `data`/`pod` axes), as an
all-reduce (psum, replicated slab) or a reduce-scatter over y (the slab
left sharded over `data` for a parallel store).

The reference's `input_sharding`/`output_spec` become plain slicing: each
rank is handed `local_projections(proj, mesh)` and returns its own part of
the volume; `assemble_volume` gathers those parts into the global layout
(tests and smoke runs). `Collectives` is the engine's one door to
torch.distributed (core/plan.py): it calls the same collectives whatever
backend the caller initialised.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.distributed as dist

from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, axis_size
from .fdk import BpImpl, warn_deprecated_once
from .geometry import CBCTGeometry
from .precision import Precision

# Row-reduce modes that leave the volume sharded over the data axis (vs
# psum's replicated slab), and the itemsize each mode moves on the wire.
SCATTER_REDUCES = ("scatter", "scatter_bf16")
REDUCE_WIRE_ITEMSIZE = {"psum": 4, "scatter": 4, "scatter_bf16": 2}


@dataclasses.dataclass(frozen=True)
class IFDKGrid:
    """The paper's 2-D rank grid: R rows (volume slabs) x C columns."""

    r: int
    c: int

    @property
    def n_ranks(self) -> int:
        return self.r * self.c


def choose_grid(g: CBCTGeometry, n_devices: int,
                hbm_bytes: int = 16 * 2**30,
                sub_vol_bytes: int = 8 * 2**30) -> IFDKGrid:
    """Paper §4.1.5: minimize R (each slab as large as fits), maximize C.

    R = sizeof(float) * Nx*Ny*Nz / N_sub_vol, rounded up to a power of two
    that divides n_devices (R = 32, C = 8 for 4096^3 on 256 GPUs of 16 GB).
    """
    vol_bytes = 4 * g.n_x * g.n_y * g.n_z
    det_bytes = 4 * g.n_u * g.n_v * 32
    # Doubling R only shrinks the slab term: a detector working set that
    # alone does not fit can never be satisfied.
    if det_bytes >= hbm_bytes:
        raise ValueError(
            f"detector working set ({det_bytes / 2**30:.2f} GiB for "
            f"{g.n_u} x {g.n_v} projections) alone exceeds "
            f"hbm_bytes={hbm_bytes / 2**30:.2f} GiB — no slab count R can "
            "fit this geometry; reduce the detector or raise hbm_bytes")
    r = 1
    while vol_bytes / r > sub_vol_bytes or (det_bytes
                                            + vol_bytes / r) > hbm_bytes:
        r *= 2
    if g.n_x % r:
        raise ValueError(
            f"memory bound needs R={r} volume slabs, but R={r} does not "
            f"tile N_x={g.n_x}; pad the volume or raise sub_vol_bytes")
    if r > n_devices:
        raise ValueError(
            f"volume needs R={r} slabs but only {n_devices} devices available"
        )
    # R is a power of two: if it does not divide n_devices, no larger one
    # does either.
    if n_devices % r:
        raise ValueError(
            f"memory bound needs R={r} volume slabs, but {r} does not "
            f"divide n_devices={n_devices}; use a device count whose "
            f"largest power-of-two factor is at least {r}, or raise "
            "sub_vol_bytes"
        )
    return IFDKGrid(r=r, c=n_devices // r)


def grid_candidates(g: CBCTGeometry, n_devices: int) -> list[IFDKGrid]:
    """Every rectangular R x C factorization of `n_devices` the engine can
    run: R | N_x and R*C | N_p, ordered by ascending R (the paper's
    preference). Empty when no factorization works."""
    if g.n_proj % n_devices:
        return []
    return [IFDKGrid(r=r, c=n_devices // r)
            for r in range(1, n_devices + 1)
            if n_devices % r == 0 and g.n_x % r == 0]


def shift_pmats_i(pmats: torch.Tensor, i0) -> torch.Tensor:
    """Reparameterize P for a volume slab starting at voxel index i0:
    P . [i + i0, j, k, 1]^T == P' . [i, j, k, 1]^T with
    P'[:, 3] = P[:, 3] + i0 * P[:, 0]."""
    out = pmats.clone()
    out[..., :, 3] += pmats[..., :, 0] * i0
    return out


def mesh_index(mesh, coord=None) -> int:
    """The row-major position in `mesh` of `coord` (default: this rank's
    coordinate); the global rank there for a mesh made by `make_mesh`."""
    idx = 0
    if coord is None:
        coord = mesh.get_coordinate()
    for c, n in zip(coord, mesh.shape):
        idx = idx * n + c
    return idx


def local_projections(proj, mesh):
    """This rank's N_p/(R*C) projections: slice `mesh_index` of the
    projection axis cut into as many equal parts as the mesh has ranks (the
    reference shards it over all mesh axes in order)."""
    n = mesh.size()
    if proj.shape[0] % n:
        raise ValueError(
            f"N_p={proj.shape[0]} must divide over the {n} ranks of the mesh")
    nl = proj.shape[0] // n
    i = mesh_index(mesh)
    return proj[i * nl:(i + 1) * nl]


def column_pmats(pmats: torch.Tensor, mesh, n_steps: int) -> torch.Tensor:
    """(n_steps, N_p/(C*n_steps), 3, 4): the P of this rank's column
    group per micro-batch, in the order the `model`-axis AllGather
    concatenates the group's projections (model coordinate order). Every
    rank derives P from the geometry, so the engine slices it here instead
    of gathering it."""
    nl = pmats.shape[0] // mesh.size()
    coord = list(mesh.get_coordinate())
    m_dim = mesh.mesh_dim_names.index(AXIS_MODEL)
    parts = []
    for m in range(mesh.shape[m_dim]):
        coord[m_dim] = m
        i = mesh_index(mesh, coord)
        parts.append(pmats[i * nl:(i + 1) * nl].reshape(
            (n_steps, nl // n_steps) + pmats.shape[1:]))
    return torch.cat(parts, dim=1)


class Collectives:
    """The engine's collectives on one rank of a mesh, by axis name.

    Each call issues one torch.distributed collective over the process
    group of that mesh axis; `bytes` counts, per collective, the bytes this
    rank handed to it. Nothing here falls back: a collective the backend
    does not carry raises from torch.distributed.
    """

    def __init__(self, mesh):
        self.groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names}
        self.bytes = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}

    def size(self, axis: str) -> int:
        return dist.get_world_size(self.groups[axis])

    def all_gather(self, t: torch.Tensor, axis: str, async_op: bool = False):
        """(out, work): every rank's `t` concatenated along dim 0 in `axis`
        order. The tensor's own bytes move (a byte view, so every wire
        dtype, fp8 included, travels as it is); with `async_op` the caller
        waits on `work` before reading `out`, else `work` is None."""
        t = t.contiguous()
        out = torch.empty((self.size(axis) * t.shape[0],) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        self.bytes["all_gather"] += t.numel() * t.element_size()
        work = dist.all_gather_into_tensor(
            _bytes(out), _bytes(t), group=self.groups[axis],
            async_op=async_op)
        return out, work

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of every rank's `t` over `axis`, in place in `t` if it is
        contiguous (else in a contiguous copy); returns the sum."""
        t = t.contiguous()
        self.bytes["all_reduce"] += t.numel() * t.element_size()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return t

    def reduce_scatter_y(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over `axis` of every rank's (x, y, ...) `t`, this rank keeping
        its 1/size share of y (dim 1), in `t`'s dtype. The collective
        scatters dim 0, so y goes in front for it (a copy) and back after."""
        src = t.movedim(1, 0).contiguous()
        n = self.size(axis)
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        self.bytes["reduce_scatter"] += src.numel() * src.element_size()
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.groups[axis])
        return out.movedim(0, 1).contiguous()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1).view(torch.uint8)


def assemble_volume(local: torch.Tensor, mesh,
                    reduce: Literal["psum", "scatter", "scatter_bf16"]
                    ) -> torch.Tensor:
    """Every rank's engine output in the global layout, on every rank.

    Gathers each rank's `local` over the default process group (which the
    mesh must span) and places it as the reference's output spec says: x
    slab-sharded over `model`, and under a scatter reduce y sharded over
    `data`. A 3-D local gives (N_x, N_y, N_z); the 4-D chunked + scatter
    store (N_x/R, y_chunks, N_y/y_chunks/C_data, N_z) gives
    (N_x, y_chunks, N_y/y_chunks, N_z), which reshape(N_x, N_y, N_z) turns
    into the canonical volume. A test and smoke-run helper.
    """
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(
            f"assemble_volume needs a mesh over the whole world ({world} "
            f"ranks); this one has {mesh.size()}")
    local = local.contiguous()
    parts = torch.empty(world * local.numel(), dtype=local.dtype,
                        device=local.device)
    dist.all_gather_into_tensor(parts, local.view(-1))
    parts = parts.view((world,) + tuple(local.shape))
    names = mesh.mesh_dim_names
    n_data = (axis_size(mesh, AXIS_DATA) if reduce in SCATTER_REDUCES
              else 1)
    ydim = local.dim() - 2   # y of (x, y, z); the chunk interior of 4-D
    slabs = []
    for m in range(axis_size(mesh, AXIS_MODEL)):
        row = []
        for d in range(n_data):
            coord = [0] * len(names)
            coord[names.index(AXIS_MODEL)] = m
            if n_data > 1:
                coord[names.index(AXIS_DATA)] = d
            row.append(parts[int(mesh.mesh[tuple(coord)])])
        slabs.append(torch.cat(row, dim=ydim))
    return torch.cat(slabs, dim=0)


def make_distributed_fdk(mesh, g: CBCTGeometry,
                         impl: BpImpl = "factorized",
                         window: str = "ramlak",
                         reduce: Literal["psum", "scatter",
                                         "scatter_bf16"] = "scatter",
                         precision: Precision | str | None = "fp32",
                         device: str = "cuda"):
    """The rank's distributed reconstruction: local projections -> local
    volume part (see `ReconstructionPlan.build`).

    Deprecated-but-stable alias: a thin wrapper over
    ``ReconstructionPlan(..., schedule="fused").build()`` (core/plan.py).
    """
    warn_deprecated_once(
        "make_distributed_fdk",
        'ReconstructionPlan(..., schedule="fused").build()')
    from .plan import ReconstructionPlan
    return ReconstructionPlan(
        geometry=g, mesh=mesh, impl=impl, window=window,
        schedule="fused", reduce=reduce, precision=precision, device=device,
    ).build()

