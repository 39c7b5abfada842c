"""Port parity: back-projection oracles and the kernel's plain version.

`repro_torch.core.backprojection`, `kernels/backproject/ref.py` and
`kernels/backproject/kernel.py::backproject_dual_torch` (what the wrapper
runs for CPU tensors) against `repro`'s oracles and its Pallas kernel in
interpret mode. The same encoded stream — identical wire bytes and scales
— feeds both sides, for every wire dtype, at a non-square detector and an
odd projection count. Tolerance rtol 1e-5 / atol 1e-6, as in
tests/test_kernels.py: both are f32 with the same operation order, so only
XLA's and torch's FMA contraction and division separate them.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backprojection as jbp
from repro.core import filtering as jfilt
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import precision as jprec
from repro.kernels.backproject.ops import backproject_mxu as jmxu
from repro.kernels.backproject.ops import backproject_pallas
from repro.kernels.backproject.ref import backproject_dual_ref as jdual_ref
from repro_torch.core import backprojection as tbp
from repro_torch.kernels.backproject import kernel as tker
from repro_torch.kernels.backproject.ops import (backproject_kernel,
                                                 backproject_mxu,
                                                 kernel_operands,
                                                 MXU_MAX_WORKING_SET,
                                                 mxu_working_set)
from repro_torch.kernels.backproject.ref import backproject_dual_ref
from repro_torch.obs.metrics import default_registry

# Tiny shapes gain nothing from intra-op threads, and the suite runs several
# test workers on one host: one thread each keeps them from contending.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16, "fp8_e4m3": torch.float8_e4m3fn,
                "fp8_e5m2": torch.float8_e5m2}
# Non-square detector (n_u != n_v), a non-cubic volume, 7 projections.
G = jgeo.CBCTGeometry(
    n_proj=7, n_u=20, n_v=14, d_u=4.8 / 20, d_v=4.8 / 20, d=4.0, dsd=8.0,
    n_x=10, n_y=8, n_z=12, d_x=0.2, d_y=0.25, d_z=2.0 / 12)
SHAPE = (G.n_x, G.n_y, G.n_z)


def to_torch(x):
    """A JAX/numpy array (any wire dtype) as a CPU tensor with the same
    bytes."""
    x = np.asarray(x)
    if x.dtype == np.float32:
        return torch.from_numpy(x.copy())
    name = {"bfloat16": "bf16", "float16": "fp16", "float8_e4m3fn": "fp8_e4m3",
            "float8_e5m2": "fp8_e5m2"}[x.dtype.name]
    dt = TORCH_DTYPES[name]
    raw = x.view(np.uint16 if dt.itemsize == 2 else np.uint8).copy()
    return torch.from_numpy(raw).view(dt)


@pytest.fixture(scope="module")
def case():
    """Projection matrices and the filtered stream, encoded by the
    reference codec for every wire dtype."""
    pm = jgeo.projection_matrices(G)
    q = jfilt.filter_projections(G, jph.forward_project(G))
    enc = {name: jprec.CODECS[name].encode(q) for name in CODECS}
    return pm, enc


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_bilinear_gather_matches():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((9, 13)).astype(np.float32)
    rows = rng.uniform(-2.5, 11.5, (40, 5)).astype(np.float32)
    cols = rng.uniform(-2.5, 15.5, (40, 5)).astype(np.float32)
    rows[0, :3] = [0.0, 8.0, -1.0]          # exact edges
    cols[0, :3] = [12.0, 0.0, 13.0]
    want = jbp.bilinear_gather(jnp.asarray(img), jnp.asarray(rows),
                               jnp.asarray(cols))
    got = tbp.bilinear_gather(torch.from_numpy(img), torch.from_numpy(rows),
                              torch.from_numpy(cols))
    assert_close(got, want)


def test_column_terms_and_dual_slab_layout(case):
    pm, _ = case
    want = jbp.column_terms(jnp.asarray(pm[2]), G.n_x, G.n_y)
    got = tbp.column_terms(torch.from_numpy(pm[2]), G.n_x, G.n_y)
    for a, b in zip(got, want):
        assert_close(a, b)
    vol = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    dual = tbp.to_dual_slab(torch.from_numpy(vol))
    np.testing.assert_array_equal(dual.numpy(),
                                  np.asarray(jbp.to_dual_slab(vol)))
    np.testing.assert_array_equal(tbp.from_dual_slab(dual).numpy(), vol)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("impl", ["reference", "factorized"])
def test_oracles_match_with_scales_and_init(case, impl, name):
    pm, enc = case
    data, scales = enc[name]
    init = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    jfn = {"reference": jbp.backproject_reference,
           "factorized": jbp.backproject_factorized}[impl]
    tfn = {"reference": tbp.backproject_reference,
           "factorized": tbp.backproject_factorized}[impl]
    want = jfn(jnp.asarray(pm), data, *SHAPE, scales=scales,
               init=jnp.asarray(init))
    got = tfn(torch.from_numpy(pm), to_torch(data), *SHAPE,
              scales=None if scales is None else to_torch(scales),
              init=torch.from_numpy(init))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    assert_close(got, want)


def test_factorized_requires_even_nz(case):
    pm, enc = case
    with pytest.raises(ValueError, match="even N_z"):
        tbp.backproject_factorized(torch.from_numpy(pm),
                                   to_torch(enc["fp32"].data), 10, 8, 11)


def test_dual_ref_matches(case):
    pm, enc = case
    qt = np.swapaxes(np.asarray(enc["bf16"].data), -1, -2)
    want = jdual_ref(jnp.asarray(pm), jnp.asarray(qt), *SHAPE)
    got = backproject_dual_ref(torch.from_numpy(pm), to_torch(qt), *SHAPE)
    assert tuple(got.shape) == (G.n_x, G.n_y, 2, G.n_z // 2)
    assert_close(got, want)


def _params13(pm, scales):
    n_p = pm.shape[0]
    sc = (np.ones((n_p, 1), np.float32) if scales is None
          else np.asarray(scales, np.float32).reshape(n_p, 1))
    return np.concatenate([pm.reshape(n_p, 12), sc], axis=1)


@pytest.mark.parametrize("name", CODECS)
def test_plain_kernel_version_matches_pallas(case, name):
    """backproject_dual_torch on the (Np, 13) rows and Q^T against the
    Pallas kernel (interpret mode, bs=4 so the odd projection count is
    padded) on the same wire bytes and scales."""
    pm, enc = case
    data, scales = enc[name]
    want = backproject_pallas(jnp.asarray(pm), data, *SHAPE, bi=5, bj=4,
                              bs=4, interpret=True, scales=scales)
    qt = to_torch(data).transpose(-1, -2).contiguous()
    got = tker.backproject_dual_torch(
        torch.from_numpy(_params13(pm, scales)), qt, *SHAPE)
    assert_close(got, jbp.to_dual_slab(want))


@pytest.mark.parametrize("name", ["fp32", "fp16", "fp8_e5m2"])
def test_kernel_operands_layout(case, name):
    """kernel_operands gives the (Np, 13) rows of `ops.py:60-63` bit for
    bit and Q^T (Np, N_u, N_v) with the wire bytes untouched."""
    pm, enc = case
    data, scales = enc[name]
    params, qt = kernel_operands(
        torch.from_numpy(pm), to_torch(data),
        None if scales is None else to_torch(scales))
    np.testing.assert_array_equal(params.numpy(), _params13(pm, scales))
    assert qt.dtype == to_torch(data).dtype and qt.is_contiguous()
    assert tuple(qt.shape) == (pm.shape[0], data.shape[2], data.shape[1])
    assert torch.equal(qt, to_torch(data).transpose(-1, -2))


@pytest.mark.parametrize("name", ["fp32", "fp8_e4m3"])
def test_ops_wrapper_matches_pallas_on_cpu(case, name):
    """backproject_kernel (layout + parameter rows + from_dual_slab) on CPU
    tensors runs the plain version and launches nothing."""
    pm, enc = case
    data, scales = enc[name]
    want = backproject_pallas(jnp.asarray(pm), data, *SHAPE, bi=5, bj=4,
                              bs=4, interpret=True, scales=scales)
    before = default_registry().value(tker.LAUNCHES)
    got = backproject_kernel(torch.from_numpy(pm), to_torch(data), *SHAPE,
                             scales=None if scales is None
                             else to_torch(scales))
    assert default_registry().value(tker.LAUNCHES) == before
    assert_close(got, want)


def test_wrapper_on_cpu_is_the_plain_version(case):
    pm, enc = case
    params = torch.from_numpy(_params13(pm, enc["fp16"].scales))
    qt = to_torch(enc["fp16"].data).transpose(-1, -2).contiguous()
    before = default_registry().value(tker.LAUNCHES)
    got = tker.backproject_dual(params, qt, *SHAPE)
    assert default_registry().value(tker.LAUNCHES) == before
    torch.testing.assert_close(
        got, tker.backproject_dual_torch(params, qt, *SHAPE), rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    pm, enc = case
    params = torch.from_numpy(_params13(pm, None))
    qt = to_torch(enc["fp32"].data).transpose(-1, -2).contiguous()
    with pytest.raises(ValueError, match="even nz"):
        tker.backproject_dual(params, qt, 10, 8, 11)
    with pytest.raises(ValueError, match=r"\(7, 13\) float32"):
        tker.backproject_dual(params[:, :12], qt, *SHAPE)
    with pytest.raises(ValueError, match="unsupported wire dtype"):
        tker.backproject_dual(params, qt.to(torch.float64), *SHAPE)
    with pytest.raises(ValueError, match=r"\(Np, Nu, Nv\)"):
        tker.backproject_dual(params, qt[0], *SHAPE)
    with pytest.raises(ValueError, match="stage_bytes must be >= 0"):
        tker.backproject_dual(params, qt, *SHAPE, stage_bytes=-1)
    with pytest.raises(ValueError, match="no back-projection kernel"):
        tker.backproject_dual(params.to("meta"), qt.to("meta"), *SHAPE)


# -- the kernel's footprint rule ---------------------------------------------

def _shifted(pm, du, dv):
    """The matrices with the detector moved by (du, dv) pixels."""
    pm = pm.copy()
    pm[:, 0, :] += du * pm[:, 2, :]
    pm[:, 1, :] += dv * pm[:, 2, :]
    return pm


def _footprint_case(name):
    g = jgeo.default_geometry(24 if name == "default_geometry(24)" else 16)
    pm = np.asarray(jgeo.projection_matrices(g))
    if name == "shifted detector":   # part of the volume misses it
        pm = _shifted(pm, 0.6 * g.n_u, -0.2 * g.n_v)
    return g, pm


def _plain_coordinates(monkeypatch, params, nu, nv, shape):
    """(u, v, v~) of every pair and projection, (Np, nx, ny, nz/2), as
    backproject_dual_torch hands them to its gather."""
    calls = []
    gather = tker._bilinear_flat

    def spy(qflat, nu_, nv_, rows, cols):
        calls.append((rows.expand(cols.shape).clone(), cols.clone()))
        return gather(qflat, nu_, nv_, rows, cols)

    monkeypatch.setattr(tker, "_bilinear_flat", spy)
    qt = torch.zeros((params.shape[0], nu, nv))
    tker.backproject_dual_torch(params, qt, *shape)
    return (torch.stack([c[0] for c in calls[0::2]]),
            torch.stack([c[1] for c in calls[0::2]]),
            torch.stack([c[1] for c in calls[1::2]]))


def _taps_outside(u, v, rows, cols, nu, nv):
    """Taps on the detector that the gathers at (u, v) read outside the
    inclusive boxes rows, cols (Np, 2), counted."""
    r0, c0 = torch.floor(u).long(), torch.floor(v).long()
    lim = [b.reshape(-1, *([1] * (u.dim() - 1))) for b in
           (rows[:, 0], rows[:, 1], cols[:, 0], cols[:, 1])]
    bad = 0
    for r in (r0, r0 + 1):
        for c in (c0, c0 + 1):
            on = (r >= 0) & (r < nu) & (c >= 0) & (c < nv)
            inside = ((r >= lim[0]) & (r <= lim[1]) & (c >= lim[2])
                      & (c <= lim[3]))
            bad += int((on & ~inside).sum())
    return bad


@pytest.mark.parametrize("tile", list(tker.TILES) + [(3, 5, 4)])
@pytest.mark.parametrize("name", ["default_geometry(16)",
                                  "default_geometry(24)", "shifted detector"])
def test_footprint_boxes_hold_every_tap(monkeypatch, name, tile):
    """Every tap the plain version reads for the pairs of a tile, front and
    mirror, lies in the footprint boxes of that tile and projection."""
    g, pm = _footprint_case(name)
    params = torch.from_numpy(_params13(pm, None))
    nzh = g.n_z // 2
    u, vf, vm = _plain_coordinates(monkeypatch, params, g.n_u, g.n_v,
                                   (g.n_x, g.n_y, g.n_z))
    n_taps = n_empty = 0
    for i0 in range(0, g.n_x, tile[0]):
        for j0 in range(0, g.n_y, tile[1]):
            for k0 in range(0, nzh, tile[2]):
                hi = (min(i0 + tile[0], g.n_x) - 1,
                      min(j0 + tile[1], g.n_y) - 1,
                      min(k0 + tile[2], nzh) - 1)
                boxes, ok = tker.footprint_boxes(params, g.n_u, g.n_v,
                                                 (i0, j0, k0), hi)
                assert ok.all()
                sl = (slice(None), slice(i0, hi[0] + 1),
                      slice(j0, hi[1] + 1), slice(k0, hi[2] + 1))
                for v, cols in ((vf, boxes[:, 2:4]), (vm, boxes[:, 4:6])):
                    assert _taps_outside(u[sl], v[sl], boxes[:, 0:2], cols,
                                         g.n_u, g.n_v) == 0
                n_taps += u[sl].numel()
                n_empty += int((boxes[:, 0] > boxes[:, 1]).sum())
    assert n_taps == g.n_proj * g.n_x * g.n_y * nzh
    if name == "shifted detector":
        assert n_empty > 0   # some tiles miss the detector there


def integer_landing_params():
    """(6, 13) rows of parallel projections (z = 1 or 2, so 1/z is exact)
    whose u and v land on whole and half pixels at many voxels, on, at and
    past both edges of a 20 x 16 detector: floor's edge cases, for a
    (12, 10, 24) volume."""
    rows = [
        # u = i + j - 3, v = j + k - 4: whole pixels, off both v edges
        [1, 1, 0, -3, 0, 1, 1, -4, 0, 0, 0, 1],
        # v moves 2 pixels a step of k, half pixels in u
        [1, 0, 0, 4.5, 0, 1, 2, -9, 0, 0, 0, 1],
        # v moves half a pixel a step of k, u past the last row for large i
        [2, 0, 0, 0, 0, 0, 0.5, 7, 0, 0, 0, 1],
        # z = 2: u = (i - j + 12) / 2, v = (2 j + k - 10) / 2
        [1, -1, 0, 12, 0, 2, 1, -10, 0, 0, 0, 2],
        # the whole volume past the detector's far v edge
        [1, 0, 0, 2, 0, 0, 1, 40, 0, 0, 0, 1],
        # u before the first row for every voxel but i = 11
        [1, 0, 0, -12, 0, 1, 1, 0, 0, 0, 0, 1],
    ]
    return torch.tensor([r + [1.0] for r in rows], dtype=torch.float32)


def _staged_box(row, nu, nv, vec):
    """The kernel's staged box for a footprint row (rows, front and mirror
    columns, inclusive): its first row and rows, the first columns of the
    front and mirror boxes and their pitch. `RING` pixels more where the
    box meets the detector's edge, a side with no pixel on the detector
    taken from columns past it, starts aligned down to the copy width; front
    and mirror side by side share one box (both start at its first column)
    where it is no wider than the two."""
    rlo, rhi, cfl, cfh, cml, cmh = row
    ring = tker.RING
    front, mirror = cfl <= cfh, cml <= cmh
    brlo = rlo - (ring if rlo == 0 else 0)
    rows = rhi + (ring if rhi == nu - 1 else 0) + 1 - brlo
    past = (nv + vec) & -vec
    cf = (cfl - (ring if cfl == 0 else 0)) & -vec if front else past
    cm = (cml - (ring if cml == 0 else 0)) & -vec if mirror else past
    wf = cfh + 1 + (ring if cfh == nv - 1 else 0) - cf if front else 0
    wm = cmh + 1 + (ring if cmh == nv - 1 else 0) - cm if mirror else 0
    pitch = -(-max(wf, wm) // vec) * vec
    both = -(-(max(cf + wf, cm + wm) - min(cf, cm)) // vec) * vec
    if front and mirror and both <= 2 * pitch:
        cf = cm = min(cf, cm)
        pitch = both
    return brlo, rows, cf, cm, pitch


def _staged_gather(params, qt, shape, t):
    """The kernel's staged gather loop on the CPU: for each tile and
    projection, the front and mirror boxes staged as the kernel stages them
    (`_staged_box`: zero off the detector), every gather's row and column
    clamped into its box with no test, three lerps, w times the sum. The
    dual-slab volume; every (tile, projection) is staged (no buffer
    limit)."""
    nx, ny, nz = shape
    n_p, nu, nv = qt.shape
    nzh = nz // 2
    vec = tker.copy_elems(nv, qt.dtype)
    q = torch.zeros((n_p, nu + 8, 2 * nv + 8 + 2 * vec))  # zero outside
    q[:, 4:4 + nu, 4 + vec:4 + vec + nv] = qt.float()
    out = torch.zeros((nx, ny, 2, nzh))
    vmax = float(nv - 1)
    for i0 in range(0, nx, t[0]):
        for j0 in range(0, ny, t[1]):
            for k0 in range(0, nzh, t[2]):
                hi = (min(i0 + t[0], nx) - 1, min(j0 + t[1], ny) - 1,
                      min(k0 + t[2], nzh) - 1)
                boxes, zpos = tker.footprint_boxes(params, nu, nv,
                                                   (i0, j0, k0), hi)
                assert zpos.all()
                i = torch.arange(i0, hi[0] + 1, dtype=torch.float32)
                j = torch.arange(j0, hi[1] + 1, dtype=torch.float32)
                k = torch.arange(k0, hi[2] + 1, dtype=torch.float32)
                i, j = i[:, None], j[None, :]
                for s, (rlo, rhi, cfl, cfh, cml, cmh) in enumerate(
                        boxes.tolist()):
                    front, mirror = cfl <= cfh, cml <= cmh
                    if rlo > rhi or not (front or mirror):
                        continue
                    p = params[s].tolist()
                    brlo, rows, cf, cm, pitch = _staged_box(
                        (rlo, rhi, cfl, cfh, cml, cmh), nu, nv, vec)
                    x0 = p[0] * i + p[1] * j + p[3]
                    y0 = p[4] * i + p[5] * j + p[7]
                    f = 1.0 / (p[8] * i + p[9] * j + p[11])
                    u, w = x0 * f, f * f * p[12]
                    r0 = torch.floor(u)
                    dr = (u - r0)[..., None]
                    roff = (r0.long().clamp(brlo, brlo + rows - 2) - brlo)
                    v = (y0[..., None] + p[6] * k) * f[..., None]
                    for h, (vv, c_lo) in enumerate(((v, cf), (vmax - v, cm))):
                        c0 = torch.floor(vv)
                        dc = vv - c0
                        col = (c0.long().clamp(c_lo, c_lo + pitch - 2)
                               - c_lo)
                        box = q[s, 4 + brlo:4 + brlo + rows,
                                4 + vec + c_lo:4 + vec + c_lo + pitch]
                        assert box.shape == (rows, pitch)
                        r = roff[..., None].expand(col.shape)
                        t00, t01 = box[r, col], box[r, col + 1]
                        t10, t11 = box[r + 1, col], box[r + 1, col + 1]
                        a0 = t00 + dc * (t01 - t00)
                        a1 = t10 + dc * (t11 - t10)
                        out[i0:hi[0] + 1, j0:hi[1] + 1, h, k0:hi[2] + 1] += \
                            w[..., None] * (a0 + dr * (a1 - a0))
    return out


# A volume tall in z for its 8 x 8 columns (130 k's a half), v moving ~2
# pixels a step of k: the outer k tiles' front and mirror boxes lie far
# apart and are staged as two, the middle ones side by side as one.
TALL = jgeo.CBCTGeometry(
    n_proj=3, n_u=24, n_v=600, d_u=0.1, d_v=0.025, d=4.0, dsd=8.0,
    n_x=8, n_y=8, n_z=260, d_x=0.1, d_y=0.1, d_z=0.025)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("tile", tker.TILES)
@pytest.mark.parametrize("name", ["default_geometry(16)", "shifted detector",
                                  "integer landings", "tall volume"])
def test_staged_gather_needs_no_bound_tests(name, tile, dtype):
    """The kernel's staged loop, with the ring of zeros where a box meets
    the detector's edge, front and mirror side by side in one box, and the
    clamps in place of bound tests, gives the plain version's sums: a
    gather with no tap on the detector lands on zeros wherever its clamp
    puts it."""
    if name == "integer landings":
        params, nu, nv, shape = integer_landing_params(), 20, 16, (12, 10, 24)
    else:
        g, pm = ((TALL, np.asarray(jgeo.projection_matrices(TALL)))
                 if name == "tall volume" else _footprint_case(name))
        params = torch.from_numpy(_params13(pm, None))
        nu, nv, shape = g.n_u, g.n_v, (g.n_x, g.n_y, g.n_z)
    qt = torch.randn((params.shape[0], nu, nv),
                     generator=torch.Generator().manual_seed(3)).to(dtype)
    want = tker.backproject_dual_torch(params, qt, *shape)
    got = _staged_gather(params, qt, shape, tile)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("axis", ["u", "v"])
def test_footprint_box_is_empty_off_the_detector(axis):
    """A tile whose columns all project past the detector's edge gets an
    empty box: no rows (u), or no front and no mirror columns (v)."""
    g = jgeo.default_geometry(16)
    shift = (3.0 * g.n_u, 0.0) if axis == "u" else (0.0, 3.0 * g.n_v)
    pm = _shifted(np.asarray(jgeo.projection_matrices(g)), *shift)
    params = torch.from_numpy(_params13(pm, None))
    boxes, ok = tker.footprint_boxes(params, g.n_u, g.n_v, (0, 0, 0),
                                     (7, 7, 7))
    assert ok.all()
    if axis == "u":
        assert bool((boxes[:, 0] > boxes[:, 1]).all())
    else:
        assert bool((boxes[:, 2] > boxes[:, 3]).all())
        assert bool((boxes[:, 4] > boxes[:, 5]).all())


# -- backproject_mxu: the relu-hat formulation --------------------------------

G16 = jgeo.default_geometry(16, n_proj=8)
# The reference's own bound for its mxu variant (tests/test_kernels.py): the
# einsums sum the taps in another order than the gathers.
MXU_RTOL, MXU_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def case16():
    pm = jgeo.projection_matrices(G16)
    q = jfilt.filter_projections(G16, jph.forward_project(G16))
    return pm, {name: jprec.CODECS[name].encode(q) for name in CODECS}


@pytest.mark.parametrize("name", CODECS)
def test_mxu_matches_reference_mxu(case16, name):
    """Port and JAX relu-hat back-projectors on the same wire bytes and
    scales at 16^3, every codec."""
    pm, enc = case16
    data, scales = enc[name]
    shape = (G16.n_x, G16.n_y, G16.n_z)
    want = jmxu(jnp.asarray(pm), data, *shape, scales=scales)
    got = backproject_mxu(
        torch.from_numpy(pm), to_torch(data), *shape,
        scales=None if scales is None else to_torch(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MXU_RTOL, atol=MXU_ATOL)


def test_mxu_matches_factorized_and_needs_no_masks(case16):
    """The reference's TestMXUVariant on the port: the factorized oracle's
    result, also for all-ones projections whose footprint leaves the
    detector (out-of-range coordinates get zero weight)."""
    pm, enc = case16
    pm = torch.from_numpy(pm)
    shape = (G16.n_x, G16.n_y, G16.n_z)
    for q in (to_torch(enc["fp32"][0]),
              torch.ones(G16.proj_shape(), dtype=torch.float32)):
        np.testing.assert_allclose(
            backproject_mxu(pm, q, *shape).numpy(),
            tbp.backproject_factorized(pm, q, *shape).numpy(),
            rtol=MXU_RTOL, atol=1e-5)


def test_mxu_refuses_a_working_set_above_its_bound():
    """At 512^3 from RabbitCT's 1248 x 960 detector the hat matrices would
    need 518 GB per projection: a ValueError, before any allocation."""
    need = mxu_working_set(512, 512, 512, 1248, 960)
    assert need == 4 * 512 * 512 * (1248 + 960 + 512 * 960) > \
        MXU_MAX_WORKING_SET >= mxu_working_set(32, 32, 32, 48, 48)
    pm = torch.from_numpy(jgeo.projection_matrices(G)[:1])
    with pytest.raises(ValueError, match="GiB bound"):
        backproject_mxu(pm, torch.zeros((1, 960, 1248)), 512, 512, 512)
    with pytest.raises(ValueError, match="even N_z"):
        backproject_mxu(pm, torch.zeros((1, 14, 20)), 10, 8, 11)
