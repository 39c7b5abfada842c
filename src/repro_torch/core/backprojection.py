"""Back-projection: reference (paper Alg. 2) and factorized (paper Alg. 4).

Port of `repro/core/backprojection.py`. Both are plain torch and serve as
oracles for the CUDA kernel (`repro_torch.kernels.backproject`). The
factorized variant implements the paper's contribution:

  * Theorem-2/3: per voxel column (i, j) the detector column u and the depth
    z (hence the weight w = 1/z^2) are constant -> computed once per column.
  * v is affine in k (v_k = (y0 + k dy) / z) -> one FMA per voxel.
  * Theorem-1 (Z-symmetry): only k in [0, Nz/2) is computed; the mirrored
    half reuses u, w and the reflected v~ = (Nv - 1) - v.
  * Layout: volume (Nx, Ny, Nz) with z innermost; projections transposed to
    Q^T = (N_u, N_v) so the inner gather walks a contiguous detector row.

The projection loop is a Python loop (the reference's `lax.scan`); the
reference's `optimization_barrier` only pins XLA's FMA contraction under
`vmap` and has no counterpart in eager torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Bilinear interpolation (paper Alg. 3) with zero-outside boundary handling
# ---------------------------------------------------------------------------

def bilinear_gather(img: Tensor, rows: Tensor, cols: Tensor) -> Tensor:
    """Sample img[rows, cols] with bilinear sub-pixel interpolation.

    Out-of-bounds neighbours contribute zero. `img` may be stored in any
    wire dtype; each gathered tap is upcast to f32 before the weighted sum.
    """
    nr, nc = img.shape
    flat = img.reshape(-1)
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    dr = rows - r0
    dc = cols - c0
    r0i = r0.to(torch.int64)
    c0i = c0.to(torch.int64)

    def tap(ri, ci, wgt):
        valid = (ri >= 0) & (ri < nr) & (ci >= 0) & (ci < nc)
        idx = ri.clamp(0, nr - 1) * nc + ci.clamp(0, nc - 1)
        return torch.where(valid, flat[idx].to(torch.float32) * wgt, 0.0)

    return (
        tap(r0i, c0i, (1 - dr) * (1 - dc))
        + tap(r0i, c0i + 1, (1 - dr) * dc)
        + tap(r0i + 1, c0i, dr * (1 - dc))
        + tap(r0i + 1, c0i + 1, dr * dc)
    )


# ---------------------------------------------------------------------------
# Reference: paper Algorithm 2 (as implemented by RTK / RabbitCT)
# ---------------------------------------------------------------------------

def _stream_scales(proj: Tensor, scales: Optional[Tensor]) -> Tensor:
    """Per-projection decode factors: the codec sidecar, or exact ones
    (multiplying by 1.0f is bit-transparent)."""
    if scales is None:
        return torch.ones((proj.shape[0],), dtype=torch.float32,
                          device=proj.device)
    return torch.as_tensor(scales, device=proj.device).to(torch.float32)


def _iotas(dev, *sizes):
    return [torch.arange(n, dtype=torch.float32, device=dev) for n in sizes]


def backproject_reference(pmats: Tensor, proj: Tensor,
                          nx: int, ny: int, nz: int,
                          scales: Optional[Tensor] = None,
                          init: Optional[Tensor] = None) -> Tensor:
    """Alg. 2: for each projection s, 3 inner products per voxel.

    pmats: (N_p, 3, 4) float32; proj: (N_p, N_v, N_u) filtered projections
    in any wire dtype; `scales` is the codec's per-projection sidecar (None
    = unscaled); `init` (default zeros) seeds the accumulator.
    Returns volume (nx, ny, nz), unscaled (see fdk.fdk_scale).
    """
    dev = proj.device
    pmats = torch.as_tensor(pmats, device=dev).to(torch.float32)
    i, j, k = _iotas(dev, nx, ny, nz)
    i, j, k = i[:, None, None], j[None, :, None], k[None, None, :]
    sc = _stream_scales(proj, scales)
    acc = (torch.zeros((nx, ny, nz), dtype=torch.float32, device=dev)
           if init is None else init.to(dev, torch.float32))
    for s in range(proj.shape[0]):
        p = pmats[s]
        x = p[0, 0] * i + p[0, 1] * j + p[0, 2] * k + p[0, 3]
        y = p[1, 0] * i + p[1, 1] * j + p[1, 2] * k + p[1, 3]
        z = p[2, 0] * i + p[2, 1] * j + p[2, 2] * k + p[2, 3]
        f = 1.0 / z
        u = x * f
        v = y * f
        w = (f * f) * sc[s]             # codec decode folded into the weight
        acc = acc + w * bilinear_gather(proj[s], v, u)  # rows = v, cols = u
    return acc


# ---------------------------------------------------------------------------
# Factorized: paper Algorithm 4
# ---------------------------------------------------------------------------

def column_terms(p: Tensor, nx: int, ny: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Per-(i,j)-column invariants (Alg. 4 lines 6-10).

    Returns (u, w, y0, dy, f): u and w constant along k (T2/T3); v_k is the
    affine ramp (y0 + k*dy) * f.
    """
    i, j = _iotas(p.device, nx, ny)
    i, j = i[:, None], j[None, :]
    x0 = p[0, 0] * i + p[0, 1] * j + p[0, 3]
    y0 = p[1, 0] * i + p[1, 1] * j + p[1, 3]
    z = p[2, 0] * i + p[2, 1] * j + p[2, 3]
    f = 1.0 / z
    return x0 * f, f * f, y0, p[1, 2], f


def backproject_factorized(pmats: Tensor, proj: Tensor,
                           nx: int, ny: int, nz: int,
                           scales: Optional[Tensor] = None,
                           init: Optional[Tensor] = None) -> Tensor:
    """Alg. 4: factorized coordinates + Z-symmetry + transposed layout.

    The accumulator lives in the dual-slab layout for the whole loop (the
    mirror half stored z-reversed); one relayout at the end restores
    (nx, ny, nz). `init` (default zeros) seeds the accumulator in the
    canonical (nx, ny, nz) layout.
    """
    if nz % 2 != 0:
        raise ValueError("factorized back-projection requires even N_z (T1 pairing)")
    dev = proj.device
    pmats = torch.as_tensor(pmats, device=dev).to(torch.float32)
    nzh = nz // 2
    n_v = proj.shape[-2]
    (k,) = _iotas(dev, nzh)
    sc = _stream_scales(proj, scales)
    if init is None:
        acc_f = torch.zeros((nx, ny, nzh), dtype=torch.float32, device=dev)
        acc_b = torch.zeros_like(acc_f)
    else:
        init = init.to(dev, torch.float32)
        acc_f = init[..., :nzh]
        acc_b = torch.flip(init[..., nzh:], dims=(-1,))
    for s in range(proj.shape[0]):
        qt = proj[s].T  # \tilde{Q}: (N_u, N_v), v contiguous
        u, w, y0, dy, f = column_terms(pmats[s], nx, ny)
        v = (y0[..., None] + dy * k) * f[..., None]        # (nx, ny, nzh)
        ub = u[..., None].expand(v.shape)
        vm = (n_v - 1.0) - v                                # Theorem-1 mirror
        w = w * sc[s]                   # codec decode folded into the weight
        acc_f = acc_f + w[..., None] * bilinear_gather(qt, ub, v)
        acc_b = acc_b + w[..., None] * bilinear_gather(qt, ub, vm)
    # single relayout: back half is voxel nz-1-k at index k
    return torch.cat([acc_f, torch.flip(acc_b, dims=(-1,))], dim=-1)


# ---------------------------------------------------------------------------
# Dual-slab layout helpers: volume (nx, ny, nz) <-> (nx, ny, 2, nz/2) where
# slab 1 is stored z-reversed so that a symmetric pair (k, nz-1-k) shares an
# index.
# ---------------------------------------------------------------------------

def to_dual_slab(vol: Tensor) -> Tensor:
    nz = vol.shape[-1]
    front = vol[..., : nz // 2]
    back = torch.flip(vol[..., nz // 2:], dims=(-1,))
    return torch.stack([front, back], dim=-2)


def from_dual_slab(dual: Tensor) -> Tensor:
    front = dual[..., 0, :]
    back = torch.flip(dual[..., 1, :], dims=(-1,))
    return torch.cat([front, back], dim=-1)
