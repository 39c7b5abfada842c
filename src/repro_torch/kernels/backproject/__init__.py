from .ops import backproject_kernel
from .ref import backproject_dual_ref
