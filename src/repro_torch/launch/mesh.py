"""Production meshes of H100 nodes (the dry run's targets).

Port of `repro/launch/mesh.py`, whose meshes are 16 x 16 TPU v5e pods.
Here the `model` axis is one HGX node's NVLink domain of 8 cards, and
`data` runs across nodes; with several node groups a `pod` axis leads.
The defaults give the reference's two chip counts: 32 nodes of 8 (256
ranks) and two groups of those (512).

Defined as functions, so importing this module touches no process group:
the dry run initialises its fake world first (`launch/dryrun.py`).
"""
from __future__ import annotations

from typing import Tuple

from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD, make_mesh
from .roofline import GPUS_PER_NODE

NODES = 32


def production_shape(nodes: int = NODES, gpus_per_node: int = GPUS_PER_NODE,
                     multi_node_groups: int = 1
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: (nodes, gpus_per_node)
    over ("data", "model"), or (groups, nodes, gpus_per_node) over
    ("pod", "data", "model") when there is more than one node group."""
    if multi_node_groups > 1:
        return ((multi_node_groups, nodes, gpus_per_node),
                (AXIS_POD, AXIS_DATA, AXIS_MODEL))
    return (nodes, gpus_per_node), (AXIS_DATA, AXIS_MODEL)


def mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def make_production_mesh(nodes: int = NODES,
                         gpus_per_node: int = GPUS_PER_NODE,
                         multi_node_groups: int = 1,
                         device_type: str = "cuda"):
    """The production mesh as a DeviceMesh over the initialised default
    process group, whose world size must be its rank count (256 with the
    defaults, 512 with two node groups)."""
    shape, axes = production_shape(nodes, gpus_per_node, multi_node_groups)
    return make_mesh(shape, axes, device_type)
