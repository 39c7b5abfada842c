"""Elastic scaling: resume a job on a different mesh.

Port of `repro/runtime/elastic.py`. The checkpoint manifest stores logical
specs (mesh axis names), not ranks, so a restore onto any mesh with the
same axis *names* re-shards on its own (checkpoint/io.load_checkpoint).
This module adds the policy layer: given the ranks that survived, build
the largest well-formed mesh and re-derive the dependent run parameters
(per-rank batch, iFDK grid).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    dropped_devices: int


def plan_remesh(devices: Sequence, model_parallel: int,
                want_pods: Optional[int] = None) -> ElasticPlan:
    """Largest (pod?, data, model) mesh from the surviving ranks `devices`.

    model_parallel is fixed by memory footprint (e.g. iFDK's R, or TP size);
    the data axis absorbs the loss. E.g. 512 ranks with model=16 -> data=32;
    after losing a node of 4, 508 ranks -> data=31 (496 used, 12 idle).
    """
    n = len(devices)
    if model_parallel > n:
        raise ValueError("not enough devices for the model-parallel degree")
    data = n // model_parallel
    if want_pods and want_pods > 1:
        # keep pods balanced: shrink data until divisible
        while data % want_pods and data > 1:
            data -= 1
        shape = (want_pods, data // want_pods, model_parallel)
        names = (AXIS_POD, AXIS_DATA, AXIS_MODEL)
    else:
        shape = (data, model_parallel)
        names = (AXIS_DATA, AXIS_MODEL)
    used = int(np.prod(shape))
    return ElasticPlan(shape, names, n - used)


def build_mesh(ranks: Sequence[int], plan: ElasticPlan,
               device_type: str = "cuda") -> DeviceMesh:
    """The plan's mesh over `ranks[:used]` (global ranks of the default
    process group), reshaped row-major to `plan.mesh_shape` with dims
    named `plan.axis_names` — the torch.distributed form of the
    reference's `Mesh(devices, names)`.

    Creating a mesh creates its process groups, which is collective: every
    rank of the default group must call this with the same arguments, the
    ranks the plan drops included. A dropped rank gets a mesh in which it
    holds no coordinate (`get_coordinate()` is None) and takes no part in
    the mesh's collectives.
    """
    used = int(np.prod(plan.mesh_shape))
    grid = torch.tensor([int(r) for r in ranks[:used]], dtype=torch.int64)
    return DeviceMesh(device_type, grid.reshape(plan.mesh_shape),
                      mesh_dim_names=tuple(plan.axis_names))
