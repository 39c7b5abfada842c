"""Circular cone-beam scan geometry and its projection matrices, in float64.

The benchmark's own statement of the scan, worked out from the physical
description alone (it imports nothing of the program):

  * the source circles the z axis at distance `d`; at angle beta it sits at
    (-d sin(beta), -d cos(beta), 0), and the flat detector faces it at
    distance `dsd`, `n_u` x `n_v` pixels of pitch `d_u` x `d_v`, centred on
    the central ray; the scan takes `n_proj` angles 2 pi k / n_proj;
  * voxel (i, j, k) of the `n_x` x `n_y` x `n_z` volume sits at
    x = (i - (n_x - 1)/2) d_x, y = -(j - (n_y - 1)/2) d_y,
    z = -(k - (n_z - 1)/2) d_z: the volume's layout as the configuration
    states it (j and k grow downward, as image rows do);
  * in the source's frame a point has lateral offset a = cos(beta) x -
    sin(beta) y, height b = -z and depth c = sin(beta) x + cos(beta) y + d,
    and lands on detector column u = dsd a / (c d_u) + (n_u - 1)/2 and row
    v = dsd b / (c d_v) + (n_v - 1)/2 (pixel centres at whole numbers).

The 3 x 4 matrix P(beta) takes the homogeneous voxel index (i, j, k, 1)
to (u c, v c, c).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_FIELDS = ("n_proj", "n_u", "n_v", "d_u", "d_v", "d", "dsd",
           "n_x", "n_y", "n_z", "d_x", "d_y", "d_z")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One scan's geometry; the fields are the configuration's keys."""

    n_proj: int
    n_u: int
    n_v: int
    d_u: float
    d_v: float
    d: float
    dsd: float
    n_x: int
    n_y: int
    n_z: int
    d_x: float
    d_y: float
    d_z: float

    @classmethod
    def from_dict(cls, fields: dict) -> "Geometry":
        missing = [k for k in _FIELDS if k not in fields]
        if missing:
            raise ValueError(f"geometry lacks {missing}")
        return cls(**{k: fields[k] for k in _FIELDS})

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def theta(self) -> float:
        """The angular step."""
        return 2.0 * math.pi / self.n_proj

    @property
    def tau_u(self) -> float:
        """Detector column pitch scaled to the rotation axis."""
        return self.d_u * self.d / self.dsd

    @property
    def tau_v(self) -> float:
        return self.d_v * self.d / self.dsd

    @property
    def n_voxels(self) -> int:
        return self.n_x * self.n_y * self.n_z

    def angles(self, device="cpu") -> torch.Tensor:
        return (torch.arange(self.n_proj, dtype=torch.float64, device=device)
                * self.theta)


def projection_matrices(g: Geometry, device="cpu") -> torch.Tensor:
    """(n_proj, 3, 4) float64: P(beta) for every angle of the scan."""
    f64 = torch.float64
    beta = g.angles(device)
    c, s = torch.cos(beta), torch.sin(beta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    # voxel index -> world point: x = d_x i + x0, y = -d_y j + y0, ...
    scale = torch.tensor([g.d_x, -g.d_y, -g.d_z], dtype=f64, device=device)
    origin = torch.tensor([-(g.n_x - 1) / 2.0 * g.d_x,
                           (g.n_y - 1) / 2.0 * g.d_y,
                           (g.n_z - 1) / 2.0 * g.d_z], dtype=f64,
                          device=device)
    # world point -> (a, b, c) in the source's frame: rows a, b, c
    rot = torch.stack([torch.stack([c, -s, zero], -1),
                       torch.stack([zero, zero, -one], -1),
                       torch.stack([s, c, zero], -1)], -2)     # (N, 3, 3)
    shift = torch.tensor([0.0, 0.0, g.d], dtype=f64, device=device)
    ext = torch.cat([rot * scale, (rot @ origin + shift)[..., None]], -1)
    intr = torch.tensor([[g.dsd / g.d_u, 0.0, (g.n_u - 1) / 2.0],
                         [0.0, g.dsd / g.d_v, (g.n_v - 1) / 2.0],
                         [0.0, 0.0, 1.0]], dtype=f64, device=device)
    return intr @ ext


def voxel_index(g: Geometry, flat: torch.Tensor) -> torch.Tensor:
    """(M, 3) float64 (i, j, k) of flat indices into the (n_x, n_y, n_z)
    volume, C order."""
    k = flat % g.n_z
    j = (flat // g.n_z) % g.n_y
    i = flat // (g.n_z * g.n_y)
    return torch.stack([i, j, k], -1).to(torch.float64)


def voxel_world(g: Geometry, ijk: torch.Tensor) -> torch.Tensor:
    """(M, 3) world points of (M, 3) voxel indices."""
    x = (ijk[:, 0] - (g.n_x - 1) / 2.0) * g.d_x
    y = -(ijk[:, 1] - (g.n_y - 1) / 2.0) * g.d_y
    z = -(ijk[:, 2] - (g.n_z - 1) / 2.0) * g.d_z
    return torch.stack([x, y, z], -1)
