"""Sharding rules for the LM substrate, as DTensor placements.

Port of `repro/parallel/sharding.py`. Logical dim names map to mesh axes
as in the reference:

  fsdp -> ("pod", "data")   parameter sharding (ZeRO-3: gathered at use)
  tp   -> "model"           tensor parallel (heads / d_ff / vocab / experts)
  dp   -> ("pod", "data")   batch dim of activations
  sp   -> "model"           sequence dim on the residual path (opt-in)

The fields, their defaults and the resolution (`axes`, `spec`,
`spec_for_shape`, `tp_size`) are the reference's. Where the reference
hands a PartitionSpec to GSPMD, which then inserts the collectives, a spec
here becomes the placements of a `torch.distributed.tensor.DTensor` on a
`DeviceMesh`: a tensor dim sharded over mesh axes a, b is `Shard(dim)` on
each of those mesh dims, every other mesh dim `Replicate()`. DTensor
shards a dim over several mesh dims in the mesh's own order, which is the
reference's major-to-minor order over (pod, data, model); a spec that
names one dim's axes in another order has no placements and raises. A
mesh dim of size 1 is always `Replicate()`.
`constrain` / `constrain_p` redistribute a DTensor to the spec's
placements (`reshard`); on a plain tensor, or without a mesh, they return
it unchanged, as the reference's do without a mesh.

The specs need only axis names and sizes: `AbstractMesh` (the counterpart
of `jax.sharding.AbstractMesh`) resolves them with no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from .mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD

LOGICAL = {
    "fsdp": (AXIS_POD, AXIS_DATA),
    "dp": (AXIS_POD, AXIS_DATA),
    "tp": (AXIS_MODEL,),
    "sp": (AXIS_MODEL,),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (major to minor). Built like JAX's: P("data", None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in rank")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dim (the port's NamedSharding)."""
    mesh: Any
    placements: Tuple[Placement, ...]


def placements_for(mesh, spec) -> Tuple[Placement, ...]:
    """The DTensor placements of `spec` (one entry per tensor dim) on
    `mesh`. A mesh dim of size 1 is Replicate() whatever the spec names
    there: each rank holds the whole tensor dim either way, and DTensor's
    view rules refuse a dim of size 1 sharded (a batch of one on a data
    axis of one). Raises ValueError if a dim's axes are not in mesh
    order."""
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {dim} is sharded over {axes}, not in the "
                f"mesh's order {tuple(names)}; DTensor cannot express it")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(dim)
    return tuple(Replicate() if sizes[n] == 1 else p
                 for n, p in zip(names, out))


def spec_of(mesh, placements, shape) -> PartitionSpec:
    """The spec of a layout (a DTensor's mesh, or an AbstractMesh, its
    placements and global shape), the inverse of `placements_for`: one
    entry per tensor dim, None, a mesh axis name, or a tuple of names in
    the mesh's order (the order in which DTensor cuts a dim over several
    mesh dims). A mesh dim of size 1 is Replicate() in `placements_for`,
    so a spec read back names no such axis: the layout is the same either
    way, each rank holding the whole dim. Raises ValueError on a Partial()
    placement (the values are partial sums, not a layout) and on a dim
    that does not divide evenly over its mesh dims (its local parts
    differ in size, which `shard_store.snapshot` cannot describe)."""
    shape = tuple(shape)
    sizes = mesh_axes(mesh)
    names = list(sizes)
    axes: List[List[str]] = [[] for _ in shape]
    for i, pl in enumerate(placements):
        if pl.is_partial():
            raise ValueError(
                f"a DTensor with placements {tuple(placements)} holds "
                f"partial sums on mesh axis {names[i]!r}, not a layout; "
                "reduce it first (sharding.settled)")
        if pl.is_shard():
            if type(pl) is not Shard:
                raise ValueError(f"placement {pl} on mesh axis "
                                 f"{names[i]!r} is not a plain Shard")
            axes[pl.dim].append(names[i])
    for dim, names_d in enumerate(axes):
        parts = math.prod(sizes[a] for a in names_d)
        if shape[dim] % parts:
            raise ValueError(
                f"dim {dim} of {shape} does not divide evenly over mesh "
                f"axes {names_d} ({parts} ranks): uneven local shards")
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a)
               for a in axes))


def reshard(x: DTensor, placements) -> DTensor:
    """`x` redistributed to `placements`, in up to three steps: the
    Partial mesh dims are reduced first (all-reduce or reduce-scatter),
    before any other dim changes the local shape (a masked partial sum,
    as an embedding lookup leaves, is masked with the shape it was made
    with); a mesh dim that moves from Shard(i) to Shard(j) then goes
    through Replicate (an all-gather, then the local slice) instead of an
    all-to-all, which gloo does not carry for every device."""
    placements = tuple(placements)
    mesh = x.device_mesh
    cur = tuple(x.placements)
    if cur == placements:
        return x
    if any(c.is_partial() for c in cur):
        cur = tuple(t if c.is_partial() else c
                    for c, t in zip(cur, placements))
        cur = tuple(Replicate() if c.is_partial() else c for c in cur)
        x = x.redistribute(mesh, cur)
    mid = tuple(Replicate() if (c.is_shard() and t.is_shard() and c != t)
                else c for c, t in zip(cur, placements))
    if mid != cur:
        x = x.redistribute(mesh, mid)
    return x.redistribute(mesh, placements)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolves logical dim names against a mesh (or none)."""

    mesh: Optional[Any] = None
    # Disable FSDP for small models where replication is cheaper.
    fsdp: bool = True
    # Shard long sequences over the model axis on the residual path.
    sequence_parallel: bool = False
    # Axes backing "fsdp"/"dp"; ("pod", "data", "model") folds the model
    # axis in as extra data parallelism.
    fsdp_axes: Tuple[str, ...] = (AXIS_POD, AXIS_DATA)
    # ZeRO-3 gather-at-use of the fsdp-sharded weights.
    zero3_gather: bool = True
    # Gather MoE expert weights at use; False keeps the routed experts
    # sharded over the model axis (expert parallelism).
    gather_moe_experts: bool = False
    # Shard the decode residual stream's feature dim over the data axes.
    decode_feature_shard: bool = False

    def axes(self, logical: Optional[str]):
        if logical == "fsdp" and not self.fsdp:
            return None
        if logical == "sp" and not self.sequence_parallel:
            return None
        if self.mesh is None:
            return None
        if logical in ("fsdp", "dp"):
            pool = self.fsdp_axes
        else:
            pool = LOGICAL[logical]
        names = mesh_axes(self.mesh)
        axes = tuple(a for a in pool if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, *logical) -> PartitionSpec:
        return P(*(self.axes(lg) for lg in logical))

    def sharding(self, *logical) -> Optional[Sharding]:
        if self.mesh is None:
            return None
        return Sharding(self.mesh,
                        placements_for(self.mesh, self.spec(*logical)))

    def _axis_size(self, axes) -> int:
        if axes is None or axes == ():
            return 1
        sizes = mesh_axes(self.mesh)
        if isinstance(axes, str):
            return sizes[axes]
        return math.prod(sizes[a] for a in axes)

    def spec_for_shape(self, shape, *logical) -> PartitionSpec:
        """Shape-aware spec: a logical axis that does not divide its dim is
        dropped (trailing mesh axes first, until the rest divides), never
        moved to another dim, and a mesh axis shards at most one dim."""
        if self.mesh is None:
            return P(*(None,) * len(shape))
        entries = [self.axes(lg) for lg in logical]
        out = [None] * len(shape)
        used = set()
        for i, ax in enumerate(entries):
            if ax is None:
                continue
            cand = (ax,) if isinstance(ax, str) else tuple(ax)
            cand = tuple(a for a in cand if a not in used)
            while cand and shape[i] % self._axis_size(cand) != 0:
                cand = cand[:-1]
            if not cand:
                continue
            out[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
        return P(*out)

    def sharding_for_shape(self, shape, *logical) -> Optional[Sharding]:
        if self.mesh is None:
            return None
        return Sharding(self.mesh, placements_for(
            self.mesh, self.spec_for_shape(shape, *logical)))

    def constrain(self, x, *logical):
        """Activation sharding constraint: a DTensor redistributed to the
        spec of its shape; anything else unchanged."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return reshard(x, placements_for(
            self.mesh, self.spec_for_shape(x.shape, *logical)))

    def constrain_p(self, x, spec):
        """Explicit-spec constraint (the MoE reshards). A dim split over
        more ranks than it has entries (a decode batch of one over a data
        axis of two) drops its trailing axes until none is left empty:
        GSPMD pads such a dim, and DTensor's view rules refuse the empty
        shards. A dim that splits unevenly but gives every rank some (60
        experts over 8) keeps its axes, as the reference's does."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        fitted = []
        for n, entry in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            axes = (() if entry is None else (entry,)
                    if isinstance(entry, str) else tuple(entry))
            while axes and self._axis_size(axes) > n:
                axes = axes[:-1]
            fitted.append(axes[0] if len(axes) == 1 else axes or None)
        return reshard(x, placements_for(self.mesh, P(*fitted)))

    def tp_size(self) -> int:
        ax = self.axes("tp") if self.mesh is not None else None
        return self._axis_size(ax) if ax is not None else 1


def tree_shardings(rules: ShardingRules, def_tree):
    """A nested dict of ParamDef-like leaves (shape, spec) -> the same dict
    of Shardings (None without a mesh)."""
    if hasattr(def_tree, "shape") and hasattr(def_tree, "spec"):
        return rules.sharding_for_shape(def_tree.shape, *def_tree.spec)
    return {k: tree_shardings(rules, v) for k, v in def_tree.items()}


# ---------------------------------------------------------------------------
# Local shards: placing a whole tensor, zeros, and each rank's offsets
# ---------------------------------------------------------------------------

def local_bounds(shape, mesh, placements) -> List[Tuple[int, int]]:
    """(offset, length) of this rank's shard along every dim of a tensor of
    global `shape`: each mesh dim that shards a dim cuts the part left by
    the mesh dims before it into equal chunks (the dims divide; see
    `spec_for_shape`)."""
    coord = mesh.get_coordinate()
    bounds = [(0, int(n)) for n in shape]
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        off, n = bounds[pl.dim]
        parts = mesh.size(i)
        if n % parts:
            raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                             f"divide over {parts} ranks")
        n //= parts
        bounds[pl.dim] = (off + coord[i] * n, n)
    return bounds


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`, by arithmetic (no
    tensor is made: a dry run would count a meta tensor as memory)."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(stride))


def wrap_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """This rank's `local` part of a contiguous tensor of global `shape`
    (differentiable, no communication). `local` is made contiguous: the
    DTensor's global strides are those of a contiguous tensor."""
    local = local.contiguous()
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


class _SummedOver(torch.autograd.Function):
    """The sum of `local` over the process groups `groups` (an all-reduce
    each); its gradient is the output's, unchanged: every rank's part
    enters the sum once."""

    @staticmethod
    def forward(ctx, local, groups):
        out = local.contiguous().clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def summed(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """This rank's part `local` of a tensor of global `shape` laid out by
    `placements`, whose Partial() mesh dims hold partial sums (each rank a
    term), reduced over those dims: the DTensor with Replicate() there,
    differentiable, each term's gradient the sum's. The loss sums over a
    sharded vocab this way, on local parts: DTensor's own reduction there
    gave wrong gradients with torch 2.11 (see
    `models.transformer._logsumexp`)."""
    out = _SummedOver.apply(local, [mesh.get_group(i) for i, p in
                                    enumerate(placements) if p.is_partial()])
    return wrap_local(out, mesh, [Replicate() if p.is_partial() else p
                                  for p in placements], shape)


def shard_tensor(full: torch.Tensor, sharding: Sharding,
                 device=None) -> DTensor:
    """This rank's part of `full` (the same on every rank, on any device)
    as a DTensor on `device`, sliced locally with no communication. The
    part is a copy, so `full` can be freed right after."""
    local = full
    for dim, (off, n) in enumerate(local_bounds(full.shape, sharding.mesh,
                                                sharding.placements)):
        local = local.narrow(dim, off, n)
    local = local.to(device=device, copy=True).contiguous()
    return wrap_local(local, sharding.mesh, sharding.placements, full.shape)


def zeros_sharded(shape, dtype, sharding: Sharding, device) -> DTensor:
    """A zero DTensor of global `shape`, only the local part allocated."""
    local = torch.zeros([n for _, n in local_bounds(
        shape, sharding.mesh, sharding.placements)], dtype=dtype,
        device=device)
    return wrap_local(local, sharding.mesh, sharding.placements, shape)


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with every Partial mesh dim reduced (Replicate there), so
    that its local part holds values, not partial sums; a tensor
    unchanged."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return reshard(x, [Replicate() if p.is_partial() else p
                       for p in x.placements])


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; a tensor unchanged."""
    return x.full_tensor() if isinstance(x, DTensor) else x
