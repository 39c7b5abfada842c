"""Topology-aware collectives, and DTensor's collectives on c10d's calls.

Port of `repro/parallel/collectives.py`. `hierarchical_psum`: two-phase
reduction for multi-pod meshes: reduce-scatter inside `data` (the fast
axis), all-reduce of the scattered shard across `pod`, then all-gather
inside `data`, so the cross-pod link carries 1/|data| of the bytes of a
flat psum over (pod, data). The reference's `lax.psum*` over named axes
become torch.distributed calls on the DeviceMesh's per-axis groups; each
takes this rank's local tensor and returns the reduced local tensor.

`use_blocking_collectives()` carries DTensor's own redistributions
(all-gather, reduce-scatter, all-reduce, and the shard-to-shard
all-to-all) over the blocking torch.distributed calls for gloo groups.
With torch 2.11, the functional collectives DTensor calls crash the
process (a segmentation fault in `wait_tensor`) on a gloo group holding
CUDA tensors, the layout of several ranks sharing one card; the blocking
calls carry the same collectives there. The all-to-all becomes an
all-gather and a local slice on every gloo group. NCCL groups keep
DTensor's own path. `parallel.mesh.make_mesh` installs it when it builds
a CUDA mesh over a gloo default group; nothing else does.
"""
from __future__ import annotations

import functools
import inspect
from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import AXIS_DATA, AXIS_POD


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def hierarchical_psum(x: torch.Tensor, mesh, *, pod_axis: str = AXIS_POD,
                      inner_axis: str = AXIS_DATA, scatter_dim: int = 0,
                      have_pod: bool = True) -> torch.Tensor:
    """Sum of x over (pod, inner) with the pod traffic cut by 1/|inner|.
    x's `scatter_dim` must divide by the inner axis's size."""
    if not have_pod:
        out = x.clone()
        dist.all_reduce(out, group=_group(mesh, inner_axis))
        return out
    inner = _group(mesh, inner_axis)
    # Phase 1: reduce-scatter along the fast axis.
    shard = _reduce_scatter(x, "sum", scatter_dim, inner)
    # Phase 2: all-reduce only the shard across pods.
    dist.all_reduce(shard, group=_group(mesh, pod_axis))
    # Phase 3: all-gather back along the fast axis.
    return _all_gather(shard, scatter_dim, inner)


def hierarchical_psum_scatter(x: torch.Tensor, mesh, *,
                              pod_axis: str = AXIS_POD,
                              inner_axis: str = AXIS_DATA,
                              scatter_dim: int = 0,
                              have_pod: bool = True) -> torch.Tensor:
    """Reduce-scatter over (pod, inner): this rank's `scatter_dim` block
    of the inner axis, summed over both, the pod phase on the shard."""
    shard = _reduce_scatter(x, "sum", scatter_dim,
                            _group(mesh, inner_axis))
    if have_pod:
        dist.all_reduce(shard, group=_group(mesh, pod_axis))
    return shard


def psum_tree(tree, mesh, axes: Sequence[str]):
    """Sum-reduce every tensor of nested dicts (or a tensor) over the given
    mesh axes, one axis after another (gradients, metrics)."""
    if isinstance(tree, torch.Tensor):
        out = tree.clone()
        for a in axes:
            dist.all_reduce(out, group=_group(mesh, a))
        return out
    return {k: psum_tree(v, mesh, axes) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocking collectives on a process group, along one tensor dim
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def _reduce_op(name: str):
    """(c10d op, divide by the group size): gloo has no average."""
    name = name.lower()
    if name == "avg":
        return dist.ReduceOp.SUM, True
    return _OPS[name], False


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, op: str, dim: int,
                    group) -> torch.Tensor:
    n = dist.get_world_size(group)
    c10d_op, avg = _reduce_op(op)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, op=c10d_op, group=group)
    if avg:
        out.div_(n)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    c10d_op, avg = _reduce_op(op)
    out = x.clone()
    dist.all_reduce(out, op=c10d_op, group=group)
    if avg:
        out.div_(dist.get_world_size(group))
    return out


# ---------------------------------------------------------------------------
# DTensor's redistributions over the blocking calls
# ---------------------------------------------------------------------------

def _process_group(group):
    """The ProcessGroup behind a functional collective's `group` argument:
    a ProcessGroup, a (DeviceMesh, mesh dim) pair, a 1-D DeviceMesh or a
    group name."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, tuple) and isinstance(group[0], DeviceMesh):
        return group[0].get_group(group[1])
    if isinstance(group, DeviceMesh):
        return group.get_group()
    if isinstance(group, str):
        return dist.distributed_c10d._resolve_process_group(group)
    return None


def _on_gloo(original, blocking, names):
    """`blocking(tensor, *args named `names`, group)` for a gloo group,
    else `original` (the arguments are bound by the original's
    signature)."""
    sig = inspect.signature(original)

    @functools.wraps(original)
    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        pg = _process_group(bound["group"])
        if pg is None or dist.get_backend(pg) != "gloo":
            return original(*args, **kwargs)
        return blocking(bound["self"], *(bound[n] for n in names), pg)
    call.blocking = True
    return call


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """Shard(gather_dim) -> Shard(shard_dim) on one mesh dim: the
    all-gather and this rank's slice, as gloo carries no all-to-all on
    every device."""
    group = mesh.get_group(mesh_dim)
    whole = _all_gather(input, gather_dim, group)
    n, r = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
    return torch.chunk(whole, n, dim=shard_dim)[r].contiguous()


_installed = False


def use_blocking_collectives() -> None:
    """Route DTensor's collectives on gloo groups through the blocking
    torch.distributed calls (see the module docstring). Idempotent."""
    global _installed
    if _installed:
        return
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    gathers = ("all_gather_tensor", "all_gather_single")
    scatters = ("reduce_scatter_tensor", "reduce_scatter_single")
    for name in gathers + scatters + ("all_reduce",):
        original = getattr(funcol, name, None)
        if original is None or getattr(original, "blocking", False):
            continue
        if name in gathers:
            call = _on_gloo(original, _all_gather, ("gather_dim",))
        elif name in scatters:
            call = _on_gloo(original, _reduce_scatter,
                            ("reduceOp", "scatter_dim"))
        else:
            call = _on_gloo(original, _all_reduce, ("reduceOp",))
        setattr(funcol, name, call)
    for module in (_collective_utils, placement_types):
        original = getattr(module, "shard_dim_alltoall", None)
        if original is None:
            continue

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim,
                     _original=original):
            if dist.get_backend(mesh.get_group(mesh_dim)) != "gloo":
                return _original(input, gather_dim, shard_dim, mesh,
                                 mesh_dim)
            return _shard_dim_alltoall(input, gather_dim, shard_dim, mesh,
                                       mesh_dim)
        setattr(module, "shard_dim_alltoall", alltoall)
    _installed = True
