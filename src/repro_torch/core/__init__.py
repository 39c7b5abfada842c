from .geometry import CBCTGeometry, default_geometry, projection_matrices
from .fdk import reconstruct, fdk_scale, gups
from .plan import ReconstructionPlan, plan_from_reference, plan_from_spec
