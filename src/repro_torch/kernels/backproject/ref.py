"""Plain-torch oracle for the back-projection kernel.

Port of `repro/kernels/backproject/ref.py`. Semantics: the factorized
Alg. 4 with dual-slab output layout (nx, ny, 2, nz/2), zero-outside
bilinear interpolation, f32 accumulation.
"""
from __future__ import annotations

import torch

from ...core.backprojection import bilinear_gather


def backproject_dual_ref(pmats: torch.Tensor, qt: torch.Tensor,
                         nx: int, ny: int, nz: int) -> torch.Tensor:
    """Oracle: pmats (Np, 3, 4) f32, qt (Np, Nu, Nv) transposed projections.

    Returns the dual-slab volume (nx, ny, 2, nz//2) float32:
      out[..., 0, k] = volume[..., k]          (front half)
      out[..., 1, k] = volume[..., nz - 1 - k] (mirrored back half)
    """
    if nz % 2:
        raise ValueError(f"dual-slab layout requires even nz, got {nz}")
    dev = qt.device
    pmats = torch.as_tensor(pmats, device=dev).to(torch.float32)
    nzh = nz // 2
    n_v = qt.shape[-1]
    i = torch.arange(nx, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(ny, dtype=torch.float32, device=dev)[None, :]
    k = torch.arange(nzh, dtype=torch.float32, device=dev)
    acc = torch.zeros((nx, ny, 2, nzh), dtype=torch.float32, device=dev)
    for s in range(qt.shape[0]):
        p = pmats[s]
        q = qt[s].to(torch.float32)
        x0 = p[0, 0] * i + p[0, 1] * j + p[0, 3]
        y0 = p[1, 0] * i + p[1, 1] * j + p[1, 3]
        z = p[2, 0] * i + p[2, 1] * j + p[2, 3]
        f = 1.0 / z
        u = x0 * f
        w = f * f
        v = (y0[..., None] + p[1, 2] * k) * f[..., None]
        ub = u[..., None].expand(v.shape)
        front = w[..., None] * bilinear_gather(q, ub, v)
        back = w[..., None] * bilinear_gather(q, ub, (n_v - 1.0) - v)
        acc = acc + torch.stack([front, back], dim=-2)
    return acc
