"""The plain FDK reference and the phantom that makes both sides' inputs,
held against analytic results at small geometries."""
import math

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401
from bench.reference import fdk, phantom
from bench.reference.geometry import (Geometry, projection_matrices,
                                      voxel_index, voxel_world)


def geometry(n=32, n_proj=64, n_u=78, n_v=60):
    return Geometry(n_proj=n_proj, n_u=n_u, n_v=n_v, d_u=4.8 / n_u,
                    d_v=4.8 / n_u, d=4.0, dsd=8.0, n_x=n, n_y=n, n_z=n,
                    d_x=2 / n, d_y=2 / n, d_z=2 / n)


def test_projection_matrices_follow_the_source_frame():
    g = geometry(n=8, n_proj=7)
    pm = projection_matrices(g)
    flat = torch.arange(g.n_voxels)
    ijk = voxel_index(g, flat)
    xyz = voxel_world(g, ijk)
    for k, beta in enumerate(g.angles().tolist()):
        x, y, z = xyz.unbind(-1)
        a = math.cos(beta) * x - math.sin(beta) * y
        b = -z
        c = math.sin(beta) * x + math.cos(beta) * y + g.d
        uvc = pm[k] @ torch.cat([ijk, torch.ones(len(flat), 1,
                                                 dtype=torch.float64)], 1).T
        assert torch.allclose(uvc[2], c)
        assert torch.allclose(uvc[0] / uvc[2],
                              g.dsd * a / (c * g.d_u) + (g.n_u - 1) / 2)
        assert torch.allclose(uvc[1] / uvc[2],
                              g.dsd * b / (c * g.d_v) + (g.n_v - 1) / 2)


def test_ramp_is_kak_slaneys_band_limited_kernel_times_tau():
    g = geometry()
    r = fdk.ramp_matrix(g)
    tau = g.tau_u
    assert r[3, 3] == pytest.approx(tau / (4 * tau * tau))
    assert r[3, 4] == pytest.approx(-tau / (math.pi * tau) ** 2)
    assert r[3, 6] == pytest.approx(-tau / (3 * math.pi * tau) ** 2)
    assert r[3, 5] == 0.0 and torch.equal(r, r.T)


def test_filter_is_a_linear_convolution_of_each_row():
    g = geometry(n_proj=2, n_u=21, n_v=5)
    proj = torch.rand(2, g.n_v, g.n_u, dtype=torch.float64)
    ones = torch.ones(g.n_v, g.n_u, dtype=torch.float64)
    q = fdk.filter_projections(g, proj, ones, fdk.ramp_matrix(g))
    lags = np.arange(-(g.n_u - 1), g.n_u)
    h = np.where(lags == 0, 1 / (4 * g.tau_u ** 2),
                 np.where(lags % 2 == 1,
                          -1 / (np.maximum(np.abs(lags), 1) * np.pi
                                * g.tau_u) ** 2, 0.0)) * g.tau_u
    want = np.convolve(proj[1, 2].numpy(), h)[g.n_u - 1:2 * g.n_u - 1]
    assert np.allclose(q[1, 2].numpy(), want)


def test_a_ray_through_a_spheres_centre_crosses_its_diameter():
    g = geometry(n_u=21, n_v=21, n_proj=4)
    sphere = np.array([[1.0, 0, 0, 0, 0.5, 0.5, 0.5,
                        1, 0, 0, 0, 1, 0, 0, 0, 1]])
    proj = phantom.project(g, sphere, dtype=torch.float64)
    assert proj[:, 10, 10] == pytest.approx([1.0] * 4, abs=1e-6)
    assert float(proj[:, 0, 0].abs().max()) == 0.0


def test_phantoms_depend_on_seed_and_index_only():
    a = phantom.ellipsoids(2**31 + 9, 0)
    assert np.array_equal(a, phantom.ellipsoids(2**31 + 9, 0))
    assert not np.array_equal(a, phantom.ellipsoids(2**31 + 9, 1))
    assert a.shape == (1 + phantom.N_FEATURES, 16)


def test_fdk_reconstructs_the_phantom():
    g = geometry()
    ells = phantom.ellipsoids(5, 0)
    vol = fdk.reconstruct(g, phantom.project(g, ells, dtype=torch.float64))
    truth = phantom.voxelize(g, ells)
    m = g.n_x // 5
    inner = (slice(m, g.n_x - m),) * 3
    rmse = float(((vol[inner] - truth[inner]) ** 2).mean().sqrt())
    # 32^3 from 64 views: edges blur over a voxel or two (0.086 measured)
    assert rmse < 0.12


def test_sampled_voxels_equal_the_whole_volume():
    g = geometry(n=12, n_proj=16, n_u=18, n_v=14)
    proj = phantom.project(g, phantom.ellipsoids(3, 1))
    whole = fdk.reconstruct(g, proj).reshape(-1)
    idx = torch.tensor([0, 5, 77, 500, g.n_voxels - 1])
    assert torch.allclose(fdk.reconstruct_at(g, proj, idx), whole[idx],
                          rtol=1e-12, atol=1e-12)
