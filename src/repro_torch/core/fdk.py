"""Single-device FDK entry point + shared helpers (scale, GUPS metric).

Port of `repro/core/fdk.py`. `reconstruct` is a thin wrapper over the plan
layer (core/plan.py) with `mesh=None, schedule="fused"`.
"""
from __future__ import annotations

import warnings
from typing import Callable, Literal

import torch

from . import backprojection as bp
from .geometry import CBCTGeometry
from .precision import Precision

BpImpl = Literal["reference", "factorized", "kernel"]

# Legacy entry points warn once per process (per entry point).
_DEPRECATION_FIRED: set = set()


def warn_deprecated_once(name: str, alternative: str) -> None:
    if name in _DEPRECATION_FIRED:
        return
    _DEPRECATION_FIRED.add(name)
    warnings.warn(
        f"{name} is deprecated; construct a ReconstructionPlan "
        f"(core/plan.py) instead — equivalent: {alternative}",
        DeprecationWarning, stacklevel=3)


def fdk_scale(g: CBCTGeometry) -> float:
    """Global FDK calibration: f = (1/2) d^2 * dbeta * sum_s w_s q_s.

    Alg. 2/4 accumulate with w = 1/z^2; the d^2, the angular step and the
    full-scan 1/2 are constants applied once at the end.
    """
    return float(0.5 * g.d * g.d * g.theta)


def _get_backprojector(impl: BpImpl) -> Callable:
    if impl == "reference":
        return bp.backproject_reference
    if impl == "factorized":
        return bp.backproject_factorized
    if impl == "kernel":
        from ..kernels.backproject.ops import backproject_kernel
        return backproject_kernel
    raise ValueError(f"unknown back-projection impl: {impl!r}")


def reconstruct(g: CBCTGeometry, projections,
                impl: BpImpl = "factorized",
                window: str = "ramlak",
                precision: Precision | str | None = "fp32",
                device="cuda") -> torch.Tensor:
    """Full FDK: (N_p, N_v, N_u) projections -> (N_x, N_y, N_z) volume on
    `device`; equivalent to ``ReconstructionPlan(geometry=g, impl=impl,
    window=window, precision=precision, device=device).build()(projections)``.
    """
    from .plan import ReconstructionPlan
    plan = ReconstructionPlan(geometry=g, impl=impl, window=window,
                              precision=precision, device=device)
    return plan.build()(projections)


def gups(g: CBCTGeometry, seconds: float) -> float:
    """The paper's metric: giga voxel-updates per second (§2.3)."""
    updates = g.n_x * g.n_y * g.n_z * float(g.n_proj)
    return updates / (seconds * 2**30)
