"""Mesh axes and helpers for the reconstruction engine, over torch.distributed.

Port of `repro/parallel/mesh.py`. Axis conventions, as in the reference:

  pod   : cross-pod data parallelism. iFDK: extra projection groups.
  data  : intra-pod data parallelism. iFDK: projection groups (paper C).
  model : volume slabs (paper R).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims.
Ranks are laid out row-major over the dims in the order given, which is
the device order of `jax.make_mesh` on the reference's CPU devices: rank
(p, d, m) of a (pod, data, model) mesh is p*D*M + d*M + m, and that order
fixes which projections each rank holds (`core/distributed.py`).

Nothing here initialises the process group: the caller does, with NCCL on
the card or gloo on the CPU (`torch.distributed.init_process_group`), and
nothing runs at import time. `named(mesh, *spec)` is the LM substrate's
sharding of a spec on a mesh (`parallel/sharding.py`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes over which data-parallel reductions run (pod present only
    multi-pod)."""
    return tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.mesh_dim_names)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of `shape` with dims named `axes` over the initialised default
    process group, whose size must be the product of `shape`.

    A CUDA mesh over a gloo group (several ranks sharing one card, where
    NCCL refuses) first routes DTensor's collectives on gloo groups over
    the blocking torch.distributed calls, process-wide
    (`collectives.use_blocking_collectives`): DTensor's own functional
    collectives crash there with torch 2.11."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group; call "
            "torch.distributed.init_process_group first (nccl on the card, "
            "gloo on the CPU)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        from .collectives import use_blocking_collectives

        use_blocking_collectives()
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1 x 1 (data, model) mesh over a world of one: every mesh program runs
    unchanged on one device (tests, smoke runs)."""
    return make_mesh((1, 1), (AXIS_DATA, AXIS_MODEL), device_type)


def axis_size(mesh: DeviceMesh, *names: str) -> int:
    """Product of the sizes of the named dims present on `mesh`."""
    n = 1
    for name in names:
        if name in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def named(mesh: DeviceMesh, *spec):
    """The Sharding (mesh and DTensor placements) of the PartitionSpec
    `spec` on `mesh`; the reference's NamedSharding(mesh, P(*spec))."""
    from .sharding import Sharding, placements_for

    return Sharding(mesh, placements_for(mesh, spec))
