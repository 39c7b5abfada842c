"""3-D Shepp-Logan phantom and analytic cone-beam forward projector.

Port of `repro/core/phantom.py`: the same ellipsoid table, the same voxel
grid and the same analytic chord lengths, computed with torch on the
caller's device. Detector pixel positions are formed in float64 (as the
reference does in numpy) and rounded to float32 once. Both functions work
in slabs (of x, or of projection angles) so that a clinical-size volume or
detector never materializes more than a few hundred megabytes of
temporaries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .geometry import CBCTGeometry, source_position

# (rho, a, b, c, x0, y0, z0, phi_deg) -- modified (high-contrast) 3D
# Shepp-Logan, Kak-Slaney / phantom3d parameterisation, z-rotation only.
SHEPP_LOGAN_3D = np.array(
    [
        [1.00, 0.6900, 0.920, 0.810, 0.00, 0.000, 0.00, 0.0],
        [-0.80, 0.6624, 0.874, 0.780, 0.00, -0.0184, 0.00, 0.0],
        [-0.20, 0.1100, 0.310, 0.220, 0.22, 0.000, 0.00, -18.0],
        [-0.20, 0.1600, 0.410, 0.280, -0.22, 0.000, 0.00, 18.0],
        [0.10, 0.2100, 0.250, 0.410, 0.00, 0.350, -0.15, 0.0],
        [0.10, 0.0460, 0.046, 0.050, 0.00, 0.100, 0.25, 0.0],
        [0.10, 0.0460, 0.046, 0.050, 0.00, -0.100, 0.25, 0.0],
        [0.10, 0.0460, 0.023, 0.050, -0.08, -0.605, 0.00, 0.0],
        [0.10, 0.0230, 0.023, 0.020, 0.00, -0.606, 0.00, 0.0],
        [0.10, 0.0230, 0.046, 0.020, 0.06, -0.605, 0.00, 0.0],
    ],
    dtype=np.float64,
)

# Work-slab sizes: voxels per shepp_logan_volume slab and detector pixels
# per forward_project angle batch (each bounds the f32 temporaries).
_VOXELS_PER_SLAB = 1 << 24
_PIXELS_PER_BATCH = 1 << 24


def _ellipsoid_frames(table: np.ndarray):
    """Per-ellipsoid (rho, center, inv-axes rotation) for unit-sphere mapping."""
    rho = table[:, 0]
    axes = table[:, 1:4]
    centers = table[:, 4:7]
    phi = np.deg2rad(table[:, 7])
    c, s = np.cos(phi), np.sin(phi)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    # rotation about z by -phi composed with axis scaling: M = diag(1/a) @ Rz(-phi)
    rot = np.stack(
        [
            np.stack([c, s, zeros], -1),
            np.stack([-s, c, zeros], -1),
            np.stack([zeros, zeros, ones], -1),
        ],
        axis=-2,
    )  # (E, 3, 3)
    minv = rot / axes[:, :, None]  # scale rows by 1/axes
    return rho, centers, minv


def _frames_f32(dev: torch.device):
    rho, centers, minv = _ellipsoid_frames(SHEPP_LOGAN_3D)
    return (rho.astype(np.float32).tolist(),
            torch.as_tensor(centers, dtype=torch.float32, device=dev),
            torch.as_tensor(minv, dtype=torch.float32, device=dev))


def _apply3(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """m (3, 3) applied to the last axis of t (..., 3), written out so no
    matrix-product path (and no TF32 setting) is involved."""
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    return torch.stack(
        [m[a, 0] * t0 + m[a, 1] * t1 + m[a, 2] * t2 for a in range(3)], -1)


def shepp_logan_volume(g: CBCTGeometry, device="cuda") -> torch.Tensor:
    """The phantom voxelized on the geometry's grid, shape (n_x, n_y, n_z)."""
    dev = resolve_device(device)
    rho, centers, minv = _frames_f32(dev)
    nx, ny, nz = g.n_x, g.n_y, g.n_z
    gx = g.d_x * (torch.arange(nx, dtype=torch.float32, device=dev)
                  - (nx - 1) / 2.0)
    gy = -g.d_y * (torch.arange(ny, dtype=torch.float32, device=dev)
                   - (ny - 1) / 2.0)
    gz = -g.d_z * (torch.arange(nz, dtype=torch.float32, device=dev)
                   - (nz - 1) / 2.0)
    vol = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    step = max(1, _VOXELS_PER_SLAB // (ny * nz))
    for x0 in range(0, nx, step):
        pts = torch.stack(
            torch.meshgrid(gx[x0:x0 + step], gy, gz, indexing="ij"), -1)
        acc = torch.zeros(pts.shape[:-1], dtype=torch.float32, device=dev)
        for e in range(len(rho)):
            q = _apply3(minv[e], pts - centers[e])
            acc += rho[e] * ((q * q).sum(-1) <= 1.0).to(torch.float32)
        vol[x0:x0 + step] = acc
    return vol


def _detector_pixels(g: CBCTGeometry, betas: np.ndarray,
                     dev: torch.device) -> torch.Tensor:
    """World positions (B, n_v, n_u, 3) of every detector pixel center at
    each angle: `geometry.detector_pixel_position` in float64 on `dev`,
    rounded to float32 once."""
    f64 = torch.float64
    cu = (g.n_u - 1) / 2.0
    cv = (g.n_v - 1) / 2.0
    cx = ((torch.arange(g.n_u, dtype=f64, device=dev) - cu) * g.d_u)[None, :]
    cy = ((torch.arange(g.n_v, dtype=f64, device=dev) - cv) * g.d_v)[:, None]
    rx, ry, rz = cx, g.dsd - g.d, -cy
    c = torch.as_tensor(np.cos(-betas), dtype=f64, device=dev)[:, None, None]
    s = torch.as_tensor(np.sin(-betas), dtype=f64, device=dev)[:, None, None]
    shape = (len(betas), g.n_v, g.n_u)
    gx = (c * rx - s * ry).expand(shape)
    gy = (s * rx + c * ry).expand(shape)
    gz = rz.expand(shape)
    return torch.stack([gx, gy, gz], -1).to(torch.float32)


def forward_project(g: CBCTGeometry, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    """Analytic cone-beam projections of the Shepp-Logan phantom.

    Returns (N_p, N_v, N_u) — the paper's E input — on `device`.
    """
    dev = resolve_device(device)
    rho, centers, minv = _frames_f32(dev)
    out = torch.empty((g.n_proj, g.n_v, g.n_u), dtype=dtype, device=dev)
    betas = g.angles
    batch = max(1, _PIXELS_PER_BATCH // (g.n_u * g.n_v))
    for a0 in range(0, g.n_proj, batch):
        bet = betas[a0:a0 + batch]
        src = torch.as_tensor(
            np.stack([source_position(g, b) for b in bet]).astype(np.float32),
            device=dev)                                   # (B, 3)
        d = _detector_pixels(g, bet, dev) - src[:, None, None, :]
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True))  # unit ray directions
        acc = torch.zeros(d.shape[:-1], dtype=torch.float32, device=dev)
        for e in range(len(rho)):
            o = _apply3(minv[e], src - centers[e])[:, None, None, :]
            dd = _apply3(minv[e], d)
            a = (dd * dd).sum(-1)
            b = 2.0 * (o * dd).sum(-1)
            c = (o * o).sum(-1) - 1.0
            disc = b * b - 4.0 * a * c
            chord = torch.where(disc > 0.0,
                                torch.sqrt(disc.clamp_min(0.0)) / a,
                                torch.zeros((), device=dev))
            acc += rho[e] * chord
        out[a0:a0 + batch] = acc.to(dtype)
    return out
