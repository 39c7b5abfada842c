"""Public wrapper around the back-projection kernel.

Port of `repro/kernels/backproject/ops.py::backproject_pallas`: the same
signature and result as the oracles in `core/backprojection.py`. It lays
the projections out as Q^T, builds the (Np, 13) parameter rows with the
codec scale in column 12, and restores the canonical volume from the
dual-slab output. The CUDA kernel loops over every projection itself, so
there is no projection-batch block and no padding; Hopper launch shapes are
fixed in the kernel source until the tuner is ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.backprojection import from_dual_slab
from .kernel import backproject_dual


def kernel_operands(pmats: torch.Tensor, proj: torch.Tensor,
                    scales: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands for `proj`: (params13, qt).

    pmats: (Np, 3, 4); proj: (Np, N_v, N_u) filtered projections (row = v)
    in any wire dtype; `scales` is the codec's per-projection sidecar (None
    = unscaled). Returns the (Np, 13) float32 parameter rows (the matrix
    row-major, the scale in column 12) and Q^T (Np, N_u, N_v), v contiguous.
    """
    dev = proj.device
    n_p = proj.shape[0]
    qt = proj.transpose(-1, -2).contiguous()
    pm = torch.as_tensor(pmats, device=dev).reshape(n_p, 12).to(torch.float32)
    sc = (torch.ones((n_p, 1), dtype=torch.float32, device=dev)
          if scales is None
          else torch.as_tensor(scales, device=dev).reshape(n_p, 1)
          .to(torch.float32))
    return torch.cat([pm, sc], dim=1).contiguous(), qt


def backproject_kernel(pmats: torch.Tensor, proj: torch.Tensor,
                       nx: int, ny: int, nz: int,
                       scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Alg. 4 via the hand-written kernel. Same signature/result as the
    oracles: operands as in `kernel_operands`; returns (nx, ny, nz) float32
    on the projections' device.
    """
    params, qt = kernel_operands(pmats, proj, scales)
    return from_dual_slab(backproject_dual(params, qt, nx, ny, nz))
