"""CBCT geometry: projection matrices and the iFDK factorization theorems.

Port of `repro/core/geometry.py`. The projection matrices are built in
numpy float64 and cast to float32 exactly as the reference does, so they
are bit-equal to the JAX package's. Only `project_voxels` touches torch.

Eq. (2) of the paper:  P_i = (M1 · Mrot · M0)[0:3, :]  with the
volume->gantry transform M0, the gantry rotation Mrot (angle beta,
source-axis distance d) and the FPD projection M1 (source-detector distance
D, pixel pitches Du, Dv). Theorems 2/3 make P[0,2] and P[2,2] structural
zeros, which the factorized back-projection (Alg. 4) relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CBCTGeometry:
    """Cone-beam CT scan geometry (paper Table 1).

    All physical quantities share one length unit (mm by convention).
    """

    n_proj: int          # N_p: number of projections over 2*pi
    n_u: int             # detector width  (pixels)
    n_v: int             # detector height (pixels)
    d_u: float           # detector pixel pitch, U direction
    d_v: float           # detector pixel pitch, V direction
    d: float             # distance source -> rotation axis
    dsd: float           # D: distance source -> detector plane
    n_x: int             # volume size X (voxels)
    n_y: int             # volume size Y
    n_z: int             # volume size Z
    d_x: float           # voxel pitch X
    d_y: float           # voxel pitch Y
    d_z: float           # voxel pitch Z

    @property
    def theta(self) -> float:
        """Rotation step angle (paper: theta = 2*pi / N_p)."""
        return 2.0 * np.pi / self.n_proj

    @property
    def magnification(self) -> float:
        return self.dsd / self.d

    @property
    def tau_u(self) -> float:
        """Detector pitch rescaled to the isocenter (virtual detector)."""
        return self.d_u * self.d / self.dsd

    @property
    def tau_v(self) -> float:
        return self.d_v * self.d / self.dsd

    @property
    def angles(self) -> np.ndarray:
        return np.arange(self.n_proj, dtype=np.float64) * self.theta

    def volume_shape(self) -> Tuple[int, int, int]:
        return (self.n_x, self.n_y, self.n_z)

    def proj_shape(self) -> Tuple[int, int, int]:
        return (self.n_proj, self.n_v, self.n_u)


def default_geometry(n: int = 64, n_proj: int | None = None) -> CBCTGeometry:
    """A well-posed test geometry reconstructing the unit ball [-1,1]^3.

    Source orbit radius 4, detector at distance 8 (magnification 2), detector
    sized to cover the unit ball with margin.
    """
    n_proj = n_proj if n_proj is not None else max(2 * n, 16)
    n_u = n_v = int(1.5 * n)
    half = 2.4  # physical detector half width at distance dsd=8
    return CBCTGeometry(
        n_proj=n_proj, n_u=n_u, n_v=n_v,
        d_u=2 * half / n_u, d_v=2 * half / n_v,
        d=4.0, dsd=8.0,
        n_x=n, n_y=n, n_z=n,
        d_x=2.0 / n, d_y=2.0 / n, d_z=2.0 / n,
    )


def paper_geometry(n_out: int = 4096, n_proj: int = 4096,
                   detector: int = 2048) -> CBCTGeometry:
    """The paper's benchmark problem (§5, Table 1): a 2048^2 x 4096
    projection set reconstructing an N^3 volume."""
    return CBCTGeometry(
        n_proj=n_proj, n_u=detector, n_v=detector, d_u=0.002, d_v=0.002,
        d=4.0, dsd=8.0, n_x=n_out, n_y=n_out, n_z=n_out,
        d_x=0.001, d_y=0.001, d_z=0.001,
    )


# ---------------------------------------------------------------------------
# Projection matrices (Eq. 2) — numpy float64, identical to the reference
# ---------------------------------------------------------------------------

def _m0(g: CBCTGeometry) -> np.ndarray:
    """Volume (voxel index) -> gantry (physical, centered) transform."""
    scale = np.diag([g.d_x, g.d_y, g.d_z, 1.0])
    center = np.array(
        [
            [1, 0, 0, -(g.n_x - 1) / 2.0],
            [0, -1, 0, (g.n_y - 1) / 2.0],
            [0, 0, -1, (g.n_z - 1) / 2.0],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return scale @ center


def _mrot(g: CBCTGeometry, beta: float) -> np.ndarray:
    """Gantry rotation about Z by beta, then camera-frame swap with source
    translated d away from the axis."""
    cam = np.array(
        [
            [1, 0, 0, 0],
            [0, 0, -1, 0],
            [0, 1, 0, g.d],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    c, s = np.cos(beta), np.sin(beta)
    rot = np.array(
        [
            [c, -s, 0, 0],
            [s, c, 0, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return cam @ rot


def _m1(g: CBCTGeometry) -> np.ndarray:
    """Perspective projection onto the FPD plane (pixel coordinates)."""
    pix = np.diag([1.0 / g.d_u, 1.0 / g.d_v, 1.0, 1.0])
    proj = np.array(
        [
            [g.dsd, 0, (g.n_u - 1) * g.d_u / 2.0, 0],
            [0, g.dsd, (g.n_v - 1) * g.d_v / 2.0, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return pix @ proj


def projection_matrix(g: CBCTGeometry, beta: float) -> np.ndarray:
    """The 3x4 projection matrix P for gantry angle beta (Eq. 2)."""
    p_hat = _m1(g) @ _mrot(g, beta) @ _m0(g)
    return p_hat[0:3, :]


def projection_matrices(g: CBCTGeometry) -> np.ndarray:
    """All N_p projection matrices, shape (N_p, 3, 4), float32."""
    mats = np.stack([projection_matrix(g, b) for b in g.angles])
    return mats.astype(np.float32)


def assert_factorizable(p, atol: float = 1e-6) -> None:
    """Verify the structural zeros required by Theorems 2 & 3."""
    p = np.asarray(p)
    bad_x = np.max(np.abs(p[..., 0, 2]))
    bad_z = np.max(np.abs(p[..., 2, 2]))
    if bad_x > atol or bad_z > atol:
        raise ValueError(
            "projection matrix is not factorizable: "
            f"|P[0,2]|={bad_x:.3e}, |P[2,2]|={bad_z:.3e} (Theorems 2/3 violated)"
        )


# ---------------------------------------------------------------------------
# Coordinate computation (used by the reference algorithm and the oracles)
# ---------------------------------------------------------------------------

def project_voxels(p: torch.Tensor, nx: int, ny: int, nz: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project every voxel index (i,j,k) through P (Alg. 2 lines 6-9).

    `p` is one (3, 4) float32 matrix; the result lives on its device.
    Returns (u, v, w) each of shape (nx, ny, nz): detector coordinates and
    the distance weight w = 1/z^2.
    """
    dev = p.device
    i = torch.arange(nx, dtype=torch.float32, device=dev)[:, None, None]
    j = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(nz, dtype=torch.float32, device=dev)[None, None, :]
    x = p[0, 0] * i + p[0, 1] * j + p[0, 2] * k + p[0, 3]
    y = p[1, 0] * i + p[1, 1] * j + p[1, 2] * k + p[1, 3]
    z = p[2, 0] * i + p[2, 1] * j + p[2, 2] * k + p[2, 3]
    f = 1.0 / z
    return x * f, y * f, f * f


def source_position(g: CBCTGeometry, beta: float) -> np.ndarray:
    """World (gantry-frame, physical) position of the X-ray source."""
    return np.array([-g.d * np.sin(beta), -g.d * np.cos(beta), 0.0])


def detector_pixel_position(g: CBCTGeometry, beta: float,
                            iu: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """World positions of detector pixel centers (iu, iv) at angle beta.

    Inverts the camera mapping used by projection_matrix: a detector pixel
    (iu, iv) sits at camera coords (cx, cy, cz=D) with
    cx = (iu - cu) * Du, cy = (iv - cv) * Dv.
    """
    cu = (g.n_u - 1) / 2.0
    cv = (g.n_v - 1) / 2.0
    cx = (np.asarray(iu, np.float64) - cu) * g.d_u
    cy = (np.asarray(iv, np.float64) - cv) * g.d_v
    # camera -> rotated gantry frame: rx = cx, rz = -cy, ry = cz - d
    rx, ry, rz = cx, g.dsd - g.d, -cy
    c, s = np.cos(-beta), np.sin(-beta)
    gx = c * rx - s * ry
    gy = s * rx + c * ry
    gz = rz * np.ones_like(gx)
    return np.stack(np.broadcast_arrays(gx, gy, gz), axis=-1)
