"""Mesh axes over torch.distributed (port of `repro/parallel/`)."""
from .mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_POD, axis_size, dp_axes, make_mesh,
    named, single_device_mesh,
)
