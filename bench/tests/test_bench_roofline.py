"""The frozen count of the back-projection's work."""
import pytest
import torch

import bench_tiny  # noqa: F401
from bench.reference.geometry import (Geometry, projection_matrices,
                                      voxel_index)
from bench.roofline import backproject as bp


@pytest.mark.parametrize("n_u,n_v", [(10, 8), (30, 24)])
def test_detector_pairs_equal_a_brute_force_count(n_u, n_v):
    g = Geometry(n_proj=10, n_u=n_u, n_v=n_v, d_u=4.8 / 24, d_v=4.8 / 24,
                 d=4.0, dsd=8.0, n_x=12, n_y=10, n_z=14, d_x=2 / 12,
                 d_y=2 / 10, d_z=2 / 14)
    flat = torch.arange(g.n_voxels)
    ijk = voxel_index(g, flat)
    ijk = ijk[ijk[:, 2] < g.n_z // 2]                 # mirrored pairs
    hom = torch.cat([ijk, torch.ones(len(ijk), 1, dtype=torch.float64)], 1)
    count = 0
    for p in projection_matrices(g):
        u, v, c = (p @ hom.T)
        u, v = u / c, v / c
        count += int(((u > -1) & (u < g.n_u) & (v > -1) & (v < g.n_v)).sum())
    assert 0 < bp.detector_pairs(g) == count < len(ijk) * g.n_proj


def test_bound_is_the_larger_term():
    g = Geometry(n_proj=496, n_u=1248, n_v=960, d_u=4.8 / 1248,
                 d_v=4.8 / 1248, d=4.0, dsd=8.0, n_x=8, n_y=8, n_z=8,
                 d_x=0.25, d_y=0.25, d_z=0.25)
    peak = {"f32_ops_per_s": 67e12, "bytes_per_s": 3.35e12}
    b = bp.bound_seconds(g, 4, peak)
    assert b["by"] == "bytes"            # a tiny volume from a big detector
    assert b["seconds"] == pytest.approx(bp.bytes_moved(g, 4) / 3.35e12)
    assert bp.bytes_moved(g, 4) == 496 * 13 * 4 + 496 * 1248 * 960 * 4 + 2048
    assert bp.operations(g) == pytest.approx(
        35 * bp.detector_pairs(g) + 21 * 8 * 8 * 496)
