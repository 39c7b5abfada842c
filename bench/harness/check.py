"""What decides `correct`: every scan due in the window landed, and each
landed volume agrees with the plain reference at a seeded sample of its
voxels.

During the window the client keeps, of each volume it receives, the
values at `sample_indices` (the same voxels for every scan of a run, drawn
from the seed, every voxel of a volume smaller than SAMPLE_VOXELS). Once
the window has closed and the program's state is freed, the reference
(bench/reference/fdk.py, float64) reconstructs each pool scan at those
voxels from the same projections, and every kept volume is compared with
the reference of the scan it was submitted with:

  rel_rmse     the largest, over scans, of ||x - r|| / ||r|| over the
               sample (x the program's values, r the reference's)
  max_rel_err  the largest, over scans, of max |x - r| / max |r|
  missing      scans due in the window that failed or never landed

Each has its limit in the configuration's file (`limits`); `missing` has
the limit 0.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

SAMPLE_VOXELS = 1 << 18


def sample_indices(n_voxels: int, seed: int, device) -> torch.Tensor:
    """Sorted flat voxel indices the run compares."""
    if n_voxels <= SAMPLE_VOXELS:
        return torch.arange(n_voxels, device=device)
    rng = np.random.default_rng([seed % 2**64, 3])
    idx = np.unique(rng.integers(0, n_voxels, SAMPLE_VOXELS))
    return torch.as_tensor(idx, device=device)


def gaps(kept: Iterable[Tuple[int, torch.Tensor]],
         refs: Dict[int, torch.Tensor]) -> Dict[str, float]:
    """rel_rmse and max_rel_err over (pool index, kept values) pairs."""
    rel_rmse = max_rel = 0.0
    for pool, x in kept:
        r = refs[pool]
        d = x.to(r.dtype) - r
        if not bool(torch.isfinite(d).all()):
            return {"rel_rmse": math.inf, "max_rel_err": math.inf}
        rel_rmse = max(rel_rmse, float(d.norm() / r.norm()))
        max_rel = max(max_rel, float(d.abs().max() / r.abs().max()))
    return {"rel_rmse": rel_rmse, "max_rel_err": max_rel}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
