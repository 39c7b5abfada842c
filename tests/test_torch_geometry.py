"""Port parity: `repro_torch.core.geometry` / `phantom` against `repro`.

The same numpy inputs go through both packages on the CPU. Projection
matrices are numpy float64 -> float32 in both, so they must be bit-equal;
the phantom and the analytic forward projector are f32 arithmetic in two
frameworks (different operation order), held at 1e-5 of the max, plus the
forward projector's own f32 round-off bound at rays that graze an
ellipsoid.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro_torch.core import geometry as tgeo
from repro_torch.core import phantom as tph

# Tiny shapes gain nothing from intra-op threads, and the suite runs several
# test workers on one host: one thread each keeps them from contending.
torch.set_num_threads(1)

REL = 1e-5

# default_geometry sets n_u == n_v; the non-square detector (and a volume
# that is not a cube) catches any u/v mix-up.
NON_SQUARE = jgeo.CBCTGeometry(
    n_proj=7, n_u=20, n_v=14, d_u=4.8 / 20, d_v=4.8 / 20, d=4.0, dsd=8.0,
    n_x=10, n_y=8, n_z=12, d_x=0.2, d_y=0.25, d_z=2.0 / 12)
GEOMETRIES = {
    "default12": jgeo.default_geometry(12, n_proj=8),
    "default24": jgeo.default_geometry(24, n_proj=36),
    "non_square": NON_SQUARE,
    "paper_small": jgeo.paper_geometry(n_out=16, n_proj=8, detector=24),
}


def to_port(g):
    return tgeo.CBCTGeometry(**dataclasses.asdict(g))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_projection_matrices_bit_equal(name):
    g = GEOMETRIES[name]
    want = jgeo.projection_matrices(g)
    got = tgeo.projection_matrices(to_port(g))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tgeo.assert_factorizable(got)


def test_geometry_fields_and_properties_match():
    g = NON_SQUARE
    tg = to_port(g)
    for prop in ("theta", "magnification", "tau_u", "tau_v"):
        assert getattr(tg, prop) == getattr(g, prop)
    np.testing.assert_array_equal(tg.angles, g.angles)
    assert tg.volume_shape() == g.volume_shape()
    assert tg.proj_shape() == g.proj_shape()
    assert dataclasses.asdict(tgeo.default_geometry(16)) == \
        dataclasses.asdict(jgeo.default_geometry(16))
    assert dataclasses.asdict(tgeo.paper_geometry()) == \
        dataclasses.asdict(jgeo.paper_geometry())


def test_assert_factorizable_rejects_non_structural_zeros():
    p = tgeo.projection_matrices(to_port(NON_SQUARE)).copy()
    p[3, 0, 2] = 1e-3
    with pytest.raises(ValueError, match="not factorizable"):
        tgeo.assert_factorizable(p)
    with pytest.raises(ValueError, match="not factorizable"):
        jgeo.assert_factorizable(p)


def test_source_and_detector_positions_bit_equal():
    g = NON_SQUARE
    iu, iv = np.meshgrid(np.arange(g.n_u), np.arange(g.n_v), indexing="xy")
    for beta in g.angles:
        np.testing.assert_array_equal(tgeo.source_position(to_port(g), beta),
                                      jgeo.source_position(g, beta))
        np.testing.assert_array_equal(
            tgeo.detector_pixel_position(to_port(g), beta, iu, iv),
            jgeo.detector_pixel_position(g, beta, iu, iv))


def test_project_voxels_matches():
    g = NON_SQUARE
    pm = jgeo.projection_matrices(g)
    for s in (0, 3):
        want = jgeo.project_voxels(jnp.asarray(pm[s]), g.n_x, g.n_y, g.n_z)
        got = tgeo.project_voxels(torch.from_numpy(pm[s]),
                                  g.n_x, g.n_y, g.n_z)
        for a, b in zip(got, want):
            assert rel_err(a.numpy(), b) < REL


@pytest.mark.parametrize("name", ["default12", "non_square"])
def test_shepp_logan_volume_matches(name):
    g = GEOMETRIES[name]
    want = np.asarray(jph.shepp_logan_volume(g))
    got = tph.shepp_logan_volume(to_port(g), device="cpu").numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < REL


def chord_roundoff(g):
    """Per-pixel f32 round-off bound of the analytic projector's chord sum.

    chord = sqrt(disc) / a with disc = b^2 - 4ac. In f32, disc carries an
    error of about two ulps of its terms, ddisc ~ 4 eps (b^2 + |4ac|); that
    moves the chord by ddisc / (2 a sqrt(disc)), and by up to
    sqrt(ddisc) / a where |disc| <= ddisc (a ray that grazes the ellipsoid
    may hit or miss it). Summed over ellipsoids with |rho|. Evaluated in
    float64 from the projector's own formula.
    """
    eps = float(np.finfo(np.float32).eps)
    rho, centers, minv = jph._ellipsoid_frames(jph.SHEPP_LOGAN_3D)
    iu, iv = np.meshgrid(np.arange(g.n_u), np.arange(g.n_v), indexing="xy")
    out = np.zeros(g.proj_shape())
    for s, beta in enumerate(g.angles):
        src = jgeo.source_position(g, beta)
        d = jgeo.detector_pixel_position(g, beta, iu, iv) - src
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        for r, m, c in zip(rho, minv, centers):
            o = m @ (src - c)
            dd = d @ m.T
            a = np.sum(dd * dd, -1)
            b = 2.0 * dd @ o
            four_ac = 4.0 * a * (o @ o - 1.0)
            disc = b * b - four_ac
            ddisc = 4 * eps * (b * b + np.abs(four_ac))
            dchord = np.where(
                disc > ddisc,
                ddisc / (2 * a * np.sqrt(np.maximum(disc, ddisc))),
                np.where(disc < -ddisc, 0.0, np.sqrt(ddisc) / a))
            out[s] += abs(r) * dchord
    return out


@pytest.mark.parametrize("name", ["default12", "non_square", "default24"])
def test_forward_project_matches(name):
    """Both packages evaluate the chord in f32, in different operation
    orders. Where a ray grazes an ellipsoid its discriminant cancels (at
    12^3, b^2 = 179 against b^2 - 4ac = 0.049), so the two differ by up to
    ~5e-4 of the max there — each is that far from the float64 value. Each
    pixel is held to 1e-5 of the max plus its f32 round-off bound
    (`chord_roundoff`), and 90 % of the pixels to 1e-5 of the max alone."""
    g = GEOMETRIES[name]
    want = np.asarray(jph.forward_project(g))
    got = tph.forward_project(to_port(g), device="cpu").numpy()
    assert got.shape == want.shape == g.proj_shape()
    err = np.abs(got.astype(np.float64) - want)
    tol = REL * np.max(np.abs(want))
    bound = chord_roundoff(g)
    assert np.all(err <= tol + bound)
    assert np.mean(err <= tol) > 0.9


def test_forward_project_angle_batches_are_independent(monkeypatch):
    """Slabbing the angles (the card's memory bound) changes no value."""
    g = to_port(NON_SQUARE)
    whole = tph.forward_project(g, device="cpu")
    monkeypatch.setattr(tph, "_PIXELS_PER_BATCH", 2 * g.n_u * g.n_v)
    monkeypatch.setattr(tph, "_VOXELS_PER_SLAB", 3 * g.n_y * g.n_z)
    torch.testing.assert_close(tph.forward_project(g, device="cpu"), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tph.shepp_logan_volume(g, device="cpu"),
        torch.tensor(np.asarray(jph.shepp_logan_volume(NON_SQUARE))),
        rtol=0, atol=REL)


def test_entry_points_default_to_the_card():
    """Without device="cpu" the port asks for CUDA, and this host has none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    g = to_port(GEOMETRIES["default12"])
    for fn in (tph.forward_project, tph.shepp_logan_volume):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(g)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.core.plan, "
        "repro_torch.kernels.backproject, repro_torch.kernels.build, "
        "repro_torch.kernels.attention, repro_torch.models.layers, "
        "repro_torch.models.transformer, repro_torch.configs.qwen2_1_5b, "
        "repro_torch.configs.yi_6b, repro_torch.serving\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
