"""Seeded ellipsoid phantoms and their analytic cone-beam projections.

The inputs both sides are given: a scan of a phantom made of ellipsoids
(a body and features inside it, drawn from the run's seed), projected by
exact line integrals along every detector ray, as the program's own
Shepp-Logan projector does (its pattern, not its code). The projections
are made on the run's device in float32, a block of angles at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import Geometry, voxel_index, voxel_world

N_FEATURES = 11
# Detector rays per block of angles (bounds the float32 temporaries).
_RAYS_PER_BLOCK = 1 << 24


def ellipsoids(seed: int, index: int) -> np.ndarray:
    """(1 + N_FEATURES, 13) float64 rows: density, centre (3), semi-axes
    (3), rotation (3 x 3, row-major), for pool scan `index` of run
    `seed`. The body lies inside the field of view of the configurations'
    detectors (|x|, |y| < 0.8, |z| < 0.65 in the geometry's units)."""
    rng = np.random.default_rng([seed % 2**64, index])
    rows = []

    def row(rho, centre, axes, rot):
        rows.append(np.concatenate([[rho], centre, axes, rot.reshape(-1)]))

    def rotation():
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        q = q * np.sign(np.diag(r))
        return q if np.linalg.det(q) > 0 else -q

    axes = np.array([rng.uniform(0.6, 0.75), rng.uniform(0.6, 0.75),
                     rng.uniform(0.5, 0.6)])
    angle = rng.uniform(0.0, np.pi)
    c, s = np.cos(angle), np.sin(angle)
    row(1.0, np.zeros(3), axes,
        np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]))
    for _ in range(N_FEATURES):
        small = rng.uniform(0.03, 0.22, 3)
        centre = rng.uniform(-0.45, 0.45, 3) * (axes - small.max())
        rho = rng.choice([-1.0, 1.0]) * rng.uniform(0.05, 0.5)
        row(rho, centre, small, rotation())
    return np.stack(rows)


def _quadrics(ells: np.ndarray):
    """Per ellipsoid: density, centre, Q = R diag(axes^-2) R^T (a point p
    lies inside when (p - centre)^T Q (p - centre) <= 1)."""
    rho, centre, axes = ells[:, 0], ells[:, 1:4], ells[:, 4:7]
    rot = ells[:, 7:16].reshape(-1, 3, 3)
    q = rot @ (np.eye(3)[None] / axes[:, None, :] ** 2) @ rot.transpose(
        0, 2, 1)
    return rho, centre, q


def project(g: Geometry, ells: np.ndarray, device="cpu",
            dtype=torch.float32) -> torch.Tensor:
    """(n_proj, n_v, n_u) line integrals of the phantom along every ray
    from the source to a detector pixel centre, computed in `dtype` and
    returned as float32."""
    rho, centre, quad = _quadrics(ells)
    out = torch.empty((g.n_proj, g.n_v, g.n_u), dtype=torch.float32,
                      device=device)
    a = ((torch.arange(g.n_u, dtype=dtype, device=device)
          - (g.n_u - 1) / 2.0) * g.d_u)[None, None, :]     # lateral
    b = ((torch.arange(g.n_v, dtype=dtype, device=device)
          - (g.n_v - 1) / 2.0) * g.d_v)[None, :, None]     # height
    betas = g.angles().numpy()
    step = max(1, _RAYS_PER_BLOCK // (g.n_u * g.n_v))
    for p0 in range(0, g.n_proj, step):
        beta = betas[p0:p0 + step]
        cb = torch.as_tensor(np.cos(beta), dtype=dtype,
                             device=device)[:, None, None]
        sb = torch.as_tensor(np.sin(beta), dtype=dtype,
                             device=device)[:, None, None]
        # ray direction source -> pixel, world frame (not normalised)
        w = (cb * a + sb * g.dsd, -sb * a + cb * g.dsd,
             (-b).expand(len(beta), g.n_v, 1))
        norm = torch.sqrt(w[0] ** 2 + w[1] ** 2 + w[2] ** 2)
        prods = {(i, j): w[i] * w[j] for i in range(3) for j in range(i, 3)}
        src = np.stack([-g.d * np.sin(beta), -g.d * np.cos(beta),
                        np.zeros_like(beta)], -1)               # (B, 3)
        acc = torch.zeros(norm.shape, dtype=dtype, device=device)
        for e in range(len(rho)):
            qe = quad[e]
            rel = src - centre[e]                               # (B, 3)
            grad = rel @ qe                                     # (B, 3)
            cc = torch.as_tensor(np.einsum("bi,bi->b", grad, rel) - 1.0,
                                 dtype=dtype, device=device)[:, None, None]
            g3 = torch.as_tensor(2.0 * grad, dtype=dtype, device=device)
            qa = sum(float(qe[i, j] * (1 if i == j else 2)) * prods[i, j]
                     for (i, j) in prods)
            qb = (g3[:, 0, None, None] * w[0] + g3[:, 1, None, None] * w[1]
                  + g3[:, 2, None, None] * w[2])
            disc = (qb * qb - 4.0 * qa * cc).clamp_min(0.0)
            acc += float(rho[e]) * (norm * torch.sqrt(disc) / qa)
        out[p0:p0 + step] = acc.to(torch.float32)
    return out


def voxelize(g: Geometry, ells: np.ndarray) -> torch.Tensor:
    """(n_x, n_y, n_z) float64 density at the voxel centres: small
    geometries only."""
    rho, centre, quad = _quadrics(ells)
    flat = torch.arange(g.n_voxels)
    pts = voxel_world(g, voxel_index(g, flat))
    vol = torch.zeros(flat.shape[0], dtype=torch.float64)
    for e in range(len(rho)):
        rel = pts - torch.as_tensor(centre[e])
        inside = ((rel @ torch.as_tensor(quad[e])) * rel).sum(-1) <= 1.0
        vol += float(rho[e]) * inside.to(torch.float64)
    return vol.reshape(g.n_x, g.n_y, g.n_z)
