"""Plain FDK reconstruction in float64 PyTorch: the benchmark's reference.

Feldkamp, Davis & Kress, J. Opt. Soc. Am. A 1(6):612, 1984, for a full
circular scan, with the filter of Kak & Slaney, "Principles of
Computerized Tomographic Imaging", ch. 3:

  1. weight each projection by the cosine of the ray's angle to the
     central ray, d / sqrt(d^2 + p^2 + zeta^2), with (p, zeta) the pixel's
     position scaled to the rotation axis;
  2. convolve every detector row with the band-limited ramp h(0) =
     1/(4 tau^2), h(n) = -1/(n pi tau)^2 for odd n, 0 for even n != 0
     (Kak & Slaney eq. 3.61; tau the column pitch at the axis), times tau,
     as a linear convolution over the whole row (no window: Ram-Lak);
  3. back-project voxel by voxel: each voxel takes the filtered
     projection at the point its centre projects to, weighted by
     d^2 / c^2 (c the voxel's depth along the central ray), summed over
     the angles and scaled by theta / 2.

Departures from the published method, each the usual discretisation:
the angular integral is the sum over the scan's angles; the filtered
projection is read between pixel centres by bilinear interpolation, with
neighbours outside the detector taken as zero; the convolution is the
direct sum (a dense Toeplitz product), not an FFT.

Every step runs in float64 with TF32 off, in blocks of projections, at
the voxels asked for (`reconstruct_at`), so that it fits beside a
program's volumes on the card. It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from .geometry import Geometry, projection_matrices, voxel_index

F64 = torch.float64
BLOCK = 16          # projections filtered and back-projected together


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cosine_weights(g: Geometry, device="cpu") -> torch.Tensor:
    """(n_v, n_u) float64 step-1 weights."""
    p = (torch.arange(g.n_u, dtype=F64, device=device)
         - (g.n_u - 1) / 2.0) * g.tau_u
    zeta = (torch.arange(g.n_v, dtype=F64, device=device)
            - (g.n_v - 1) / 2.0) * g.tau_v
    return g.d / torch.sqrt(g.d * g.d + p[None, :] ** 2 + zeta[:, None] ** 2)


def ramp_matrix(g: Geometry, device="cpu") -> torch.Tensor:
    """(n_u, n_u) float64 R with R[m, n] = tau h(n - m): a row e filters
    to e @ R."""
    tau = g.tau_u
    lag = (torch.arange(g.n_u, device=device)[None, :]
           - torch.arange(g.n_u, device=device)[:, None]).abs()
    odd = (lag % 2 == 1)
    h = torch.where(odd, -1.0 / (lag.to(F64) * math.pi * tau) ** 2,
                    torch.zeros((), dtype=F64, device=device))
    h = torch.where(lag == 0, torch.full((), 1.0 / (4.0 * tau * tau),
                                         dtype=F64, device=device), h)
    return h * tau


def filter_projections(g: Geometry, proj: torch.Tensor,
                       cos_w: torch.Tensor, ramp: torch.Tensor
                       ) -> torch.Tensor:
    """Steps 1-2 on a (B, n_v, n_u) block, float64."""
    _no_tf32()
    e = proj.to(F64) * cos_w
    return (e.reshape(-1, g.n_u) @ ramp).reshape(e.shape)


def bilinear(q: torch.Tensor, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """q (B, n_v, n_u) read at column u, row v (both (B, M)); taps outside
    the detector count zero."""
    b, n_v, n_u = q.shape
    flat = q.reshape(-1)
    base = (torch.arange(b, device=q.device) * (n_v * n_u))[:, None]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)
    out = torch.zeros_like(u)
    for dv, wv in ((0, 1.0 - fv), (1, fv)):
        for du, wu in ((0, 1.0 - fu), (1, fu)):
            r, c = v0 + dv, u0 + du
            inside = (r >= 0) & (r < n_v) & (c >= 0) & (c < n_u)
            idx = base + r.clamp(0, n_v - 1) * n_u + c.clamp(0, n_u - 1)
            out += torch.where(inside, flat[idx] * (wv * wu), 0.0)
    return out


def reconstruct_at(g: Geometry, projections: torch.Tensor,
                   flat: torch.Tensor) -> torch.Tensor:
    """FDK at the voxels with flat (C-order) indices `flat`, float64 (M,).

    `projections` (n_proj, n_v, n_u) in any float type, on the device the
    work runs on; `flat` on the same device."""
    dev = projections.device
    pm = projection_matrices(g, dev)
    cos_w = cosine_weights(g, dev)
    ramp = ramp_matrix(g, dev)
    hom = torch.cat([voxel_index(g, flat),
                     torch.ones((flat.shape[0], 1), dtype=F64, device=dev)],
                    -1).T                                     # (4, M)
    acc = torch.zeros(flat.shape[0], dtype=F64, device=dev)
    for p0 in range(0, g.n_proj, BLOCK):
        q = filter_projections(g, projections[p0:p0 + BLOCK], cos_w, ramp)
        uvc = pm[p0:p0 + BLOCK] @ hom                         # (B, 3, M)
        c = uvc[:, 2]
        val = bilinear(q, uvc[:, 0] / c, uvc[:, 1] / c)
        acc += (val * (g.d * g.d) / (c * c)).sum(0)
    return acc * (g.theta / 2.0)


def reconstruct(g: Geometry, projections: torch.Tensor) -> torch.Tensor:
    """The whole (n_x, n_y, n_z) volume, float64: small geometries only."""
    flat = torch.arange(g.n_voxels, device=projections.device)
    return reconstruct_at(g, projections, flat).reshape(
        g.n_x, g.n_y, g.n_z)
