"""Fault tolerance and elastic re-meshing (port of `repro/runtime`)."""
from .fault_tolerance import (  # noqa: F401
    ResumableReconstruction, StragglerMonitor, restart_loop,
)
from .elastic import ElasticPlan, plan_remesh, build_mesh  # noqa: F401
