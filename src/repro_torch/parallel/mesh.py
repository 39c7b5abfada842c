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
nothing runs at import time. The reference's `named` (a JAX sharding helper
for the LM substrate) returns with ROADMAP.md Queue 1 item 19.
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
    process group, whose size must be the product of `shape`."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group; call "
            "torch.distributed.init_process_group first (nccl on the card, "
            "gloo on the CPU)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
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
