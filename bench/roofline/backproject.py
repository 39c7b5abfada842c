"""The back-projection's operations and bytes: a frozen count of the work.

What one back-projection of a whole scan needs, whatever kernel does it
(the count of the program's original kernel study, copied here so that a
change to the program cannot change the yardstick):

  operations  COLUMN_OPS per voxel column (i, j) and projection, plus
              PAIR_OPS per mirrored voxel pair (i, j, k < n_z / 2) and
              projection whose gathers touch the detector (u in (-1, n_u)
              and v in (-1, n_v)); a multiply-add counts 2. The column
              terms: x0, y0, z (4 each), 1/z, u = x0/z, w = s/z^2 (2),
              floor(u), its fraction and complement (3), and v(k) = a + b k's
              a and b (1 each): 21. A pair: v(k) (2), the mirror (1), two
              4-tap gathers at 14 (floor, fraction, complement, 4 weights,
              4 products, 3 sums) and two weighted accumulates (2 each): 35.
              The pairs are counted in float64 per column, from v(k)'s
              crossings of -1 and n_v.
  bytes       every input read once and the output written once: the
              (n_proj, 13) float32 parameter rows, the filtered projections
              in the wire type, and the float32 volume.

`bound_seconds` is the larger of operations over the peak float32 rate
(the work runs outside the tensor cores) and bytes over the peak memory
rate.
"""
from __future__ import annotations

import torch

from bench.reference.geometry import Geometry, projection_matrices

COLUMN_OPS = 21
PAIR_OPS = 35
PARAM_COLUMNS = 13


def detector_pairs(g: Geometry, device="cpu") -> int:
    """Mirrored voxel pairs x projections whose gathers touch the
    detector (front and mirror touch it together)."""
    f64 = torch.float64
    i = torch.arange(g.n_x, dtype=f64, device=device)[:, None]
    j = torch.arange(g.n_y, dtype=f64, device=device)[None, :]
    nzh = g.n_z // 2
    total = torch.zeros((), dtype=f64, device=device)
    for p in projection_matrices(g, device).reshape(-1, 12).tolist():
        c = p[8] * i + p[9] * j + p[11]
        u = (p[0] * i + p[1] * j + p[3]) / c
        a = (p[4] * i + p[5] * j + p[7]) / c          # v(k) = a + b k
        b = p[6] / c
        if p[6] == 0.0:
            n = torch.where((a > -1) & (a < g.n_v), float(nzh), 0.0)
        else:
            k1 = (-1.0 - a) / b
            k2 = (g.n_v - a) / b
            lo = (torch.floor(torch.minimum(k1, k2)) + 1).clamp(min=0)
            hi = (torch.ceil(torch.maximum(k1, k2)) - 1).clamp(max=nzh - 1)
            n = (hi - lo + 1).clamp(min=0)
        total += torch.where((u > -1) & (u < g.n_u), n, 0.0).sum()
    return int(total)


def operations(g: Geometry, device="cpu") -> float:
    return float(PAIR_OPS * detector_pairs(g, device)
                 + COLUMN_OPS * g.n_x * g.n_y * g.n_proj)


def bytes_moved(g: Geometry, wire_itemsize: int) -> float:
    return float(g.n_proj * PARAM_COLUMNS * 4
                 + g.n_proj * g.n_u * g.n_v * wire_itemsize
                 + g.n_voxels * 4)


def bound_seconds(g: Geometry, wire_itemsize: int, peak: dict,
                  device="cpu") -> dict:
    """The least time one back-projection of the scan can take on a
    device with `peak` rates, and which term bounds it."""
    ops_s = operations(g, device) / peak["f32_ops_per_s"]
    bytes_s = bytes_moved(g, wire_itemsize) / peak["bytes_per_s"]
    return {"seconds": max(ops_s, bytes_s),
            "by": "operations" if ops_s >= bytes_s else "bytes",
            "operations_s": ops_s, "bytes_s": bytes_s}
