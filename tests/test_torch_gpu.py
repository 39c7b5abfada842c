"""Card-only tests of the port: the hand-written CUDA kernels against their
plain torch versions on the card, and the main paths through them.

Marked `gpu`; each test skips unless a CUDA device is present (decided
inside the test, never at import). This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import filtering as tfilt
from repro_torch.core.distributed import shift_pmats_i
from repro_torch.core.filtering import make_filter
from repro_torch.core.geometry import CBCTGeometry, projection_matrices
from repro_torch.core.phantom import forward_project
from repro_torch.core.plan import ReconstructionPlan, shift_pmats_j
from repro_torch.core.precision import CODECS
from repro_torch.io import load_array, read_manifest, save_array
from repro_torch.io.streams import (
    AsyncWriteback, ProjectionSource, VolumeSink)
from repro_torch.kernels.attention import (
    attention_ref, flash_attention, flash_attention_trainable)
from repro_torch.kernels.attention import kernel as fak
from repro_torch.kernels.attention.ref import (attention_f64, f64_distances,
                                               within_plain_rounding)
from repro_torch.kernels.backproject import kernel as bpk
from repro_torch.kernels.backproject import tune
from repro_torch.kernels.backproject.ops import kernel_operands
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.filter import kernel as rfk
from repro_torch.models import layers
from repro_torch.models.transformer import init_params, prefill
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import Tracer, set_tracer
from repro_torch.optim import AdamWConfig
from repro_torch.serving import greedy_generate
from repro_torch.training import (
    init_train_state, make_train_step, train_state_from_reference)

pytestmark = pytest.mark.gpu

REL = 1e-5  # see chip_smoke.py: identical wire bytes, pinned coordinates
# Non-square detector, odd projection count, a volume that is not a cube
# and a k extent that is not a multiple of the 32-wide warp.
G = CBCTGeometry(n_proj=7, n_u=40, n_v=28, d_u=4.8 / 40, d_v=4.8 / 40,
                 d=4.0, dsd=8.0, n_x=20, n_y=12, n_z=36,
                 d_x=0.1, d_y=2 / 12, d_z=2 / 36)
SHAPE = (G.n_x, G.n_y, G.n_z)


def counted(name):
    """A kernel counter of the default metrics registry."""
    return obs_metrics.default_registry().value(name, 0)


def launch_counts(fn):
    """fn() in one fenced span of an enabled tracer, whose fence reads the
    back-projection launches' direct and ring-wait counts: its result, and
    how far it advanced the registry's `kernels.backproject.*` counters."""
    names = (bpk.LAUNCHES, bpk.TILE_PAIRS, bpk.DIRECT_PAIRS, bpk.RING_WAITS)
    before = [counted(n) for n in names]
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        with tracer.span("test.launch") as sp:
            out = sp.fence(fn())
    finally:
        set_tracer(prev)
    moved = {n.rsplit(".", 1)[1]: counted(n) - b
             for n, b in zip(names, before)}
    assert (sp.args.get("direct_pairs", 0), sp.args.get("tile_pairs", 0),
            sp.args.get("ring_waits", 0)) \
        == (moved["direct_pairs"], moved["tile_pairs"], moved["ring_waits"])
    return out, moved


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _hermetic_caches(tmp_path, monkeypatch):
    """The tuning and calibration files under the test's directory (this
    file runs without the JAX conftest, which does that for the CPU
    suite)."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "calib.json"))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_kernel_matches_plain_version(cuda, codec):
    q = make_filter(G, device=cuda)(forward_project(G, device=cuda))
    data, scales = CODECS[codec].encode(q)
    params, qt = kernel_operands(projection_matrices(G), data, scales)
    before = counted(bpk.LAUNCHES)
    got = bpk.backproject_dual(params, qt, *SHAPE)
    assert counted(bpk.LAUNCHES) == before + 1
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (G.n_x, G.n_y, 2, G.n_z // 2)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= REL


def _tile_boxes(params):
    """The footprint boxes of every kernel tile of G, (Np, 6) each."""
    ti, tj, tk = bpk.tile()
    nzh = G.n_z // 2
    return [bpk.footprint_boxes(
                params.cpu(), G.n_u, G.n_v, (i0, j0, k0),
                (min(i0 + ti, G.n_x) - 1, min(j0 + tj, G.n_y) - 1,
                 min(k0 + tk, nzh) - 1))[0]
            for i0 in range(0, G.n_x, ti) for j0 in range(0, G.n_y, tj)
            for k0 in range(0, nzh, tk)]


def _edge_operands(cuda, codec):
    """G's projections with the detector moved by a third of its width, so
    that column tiles straddle its edge, encoded by `codec`."""
    pm = projection_matrices(G).copy()
    pm[:, 0, :] += G.n_u / 3 * pm[:, 2, :]
    q = make_filter(G, device=cuda)(forward_project(G, device=cuda))
    data, scales = CODECS[codec].encode(q)
    return kernel_operands(pm, data, scales)


@pytest.mark.parametrize("codec", ["fp32", "fp16", "fp8_e4m3"])
def test_kernel_matches_plain_version_at_the_detector_edge(cuda, codec):
    params, qt = _edge_operands(cuda, codec)
    clipped = sum(  # nonempty row ranges cut at the detector's edge
        int(((b[:, 0] <= b[:, 1]) & ((b[:, 0] == 0) | (b[:, 1] == G.n_u - 1)))
            .sum()) for b in _tile_boxes(params))
    assert clipped > 0
    got, moved = launch_counts(lambda: bpk.backproject_dual(params, qt,
                                                            *SHAPE))
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert moved["direct_pairs"] == 0 and moved["launches"] == 1
    assert float((got - want).abs().max() / want.abs().max()) <= REL


@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp8_e5m2"])
def test_direct_gather_matches_plain_version(cuda, codec):
    """A staging budget too small for any box sends every (tile,
    projection) with a nonempty box to the direct gather from global
    memory (an empty one has no tap to gather): the same sums."""
    params, qt = _edge_operands(cuda, codec)
    nonempty = sum(int(((b[:, 0] <= b[:, 1]) & ((b[:, 2] <= b[:, 3])
                                                 | (b[:, 4] <= b[:, 5])))
                       .sum()) for b in _tile_boxes(params))
    got, moved = launch_counts(lambda: bpk.backproject_dual(
        params, qt, *SHAPE, stage_bytes=64))
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert moved["direct_pairs"] == nonempty > 0
    assert float((got - want).abs().max() / want.abs().max()) <= REL


# -- launch shapes: the compiled tiles, the staging model, the tuner ---------

@pytest.mark.parametrize("stage_bytes", [None, 0, 2048])
@pytest.mark.parametrize("t", bpk.TILES)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_every_tile_matches_plain_version(cuda, codec, t, stage_bytes):
    """Every compiled tile, at the default staging, none and a small one:
    the plain version's sums, and as many direct gathers as the tuner's
    staging model (kernel.staging_stats) counts."""
    params, qt = _edge_operands(cuda, codec)
    got, moved = launch_counts(lambda: bpk.backproject_dual(
        params, qt, *SHAPE, tile=t, stage_bytes=stage_bytes))
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= REL
    model = bpk.staging_stats(params, G.n_u, G.n_v, G.n_x, G.n_y,
                              G.n_z // 2, t, stage_bytes, qt.dtype)
    assert moved["direct_pairs"] == model["direct"]
    assert moved["tile_pairs"] == model["pairs"]


def test_compiled_tiles_and_shared_memory_model(cuda):
    assert bpk.tiles() == bpk.TILES and bpk.tile() == bpk.DEFAULT_TILE
    assert bpk.smem_optin(cuda) >= 48 * 1024
    for dtype in bpk.WIRE_DTYPES:
        for t in bpk.TILES:
            assert bpk.compiled_static_smem(dtype, t) == \
                bpk.static_smem_bytes(t)
    params, qt = _edge_operands(cuda, "fp32")
    with pytest.raises(ValueError, match="not compiled"):
        bpk.backproject_dual(params, qt, *SHAPE, tile=(8, 8, 16))
    with pytest.raises(RuntimeError, match="launch failed"):
        bpk.backproject_dual(params, qt, *SHAPE, stage_bytes=1 << 20)


# Geometries where v moves ~2 pixels a step of k (as at RabbitCT 512^3,
# where a warp's tap reads span two shared-memory wavefronts) and ~0.75 (as
# at 1024^3), with partial tiles on every axis.
STRIDES = {
    "2px": (CBCTGeometry(n_proj=5, n_u=48, n_v=140, d_u=0.1, d_v=0.05,
                         d=4.0, dsd=8.0, n_x=20, n_y=12, n_z=130,
                         d_x=0.1, d_y=0.1, d_z=0.05), (1.5, 2.5)),
    "0.75px": (CBCTGeometry(n_proj=5, n_u=48, n_v=112, d_u=0.1, d_v=0.1,
                            d=4.0, dsd=8.0, n_x=20, n_y=12, n_z=140,
                            d_x=0.1, d_y=0.1, d_z=0.0375), (0.6, 0.9)),
}


def integer_landing_params():
    """(6, 13) rows of parallel projections (z = 1 or 2, so 1/z is exact)
    whose u and v land on whole and half pixels at many voxels, on, at and
    past both edges of a 20 x 16 detector, for a (12, 10, 24) volume (the
    CPU tests' staged-gather model runs the same rows)."""
    rows = [
        [1, 1, 0, -3, 0, 1, 1, -4, 0, 0, 0, 1],
        [1, 0, 0, 4.5, 0, 1, 2, -9, 0, 0, 0, 1],
        [2, 0, 0, 0, 0, 0, 0.5, 7, 0, 0, 0, 1],
        [1, -1, 0, 12, 0, 2, 1, -10, 0, 0, 0, 2],
        [1, 0, 0, 2, 0, 0, 1, 40, 0, 0, 0, 1],
        [1, 0, 0, -12, 0, 1, 1, 0, 0, 0, 0, 1],
    ]
    return torch.tensor([r + [1.0] for r in rows], dtype=torch.float32)


def _mixed_stage_bytes(params, nu, nv, shape, t, dtype):
    """A staging budget between the boxes of a launch's (tile, projection)
    pairs: some stage, some go to the direct gather."""
    for px in (256, 512, 1024, 2048, 4096, 8192):
        st = bpk.staging_stats(params.cpu(), nu, nv, shape[0], shape[1],
                               shape[2] // 2, t, px * dtype.itemsize, dtype)
        if st["direct"] and st["staged"]:
            return px * dtype.itemsize
    return None


@pytest.mark.parametrize("stage", ["default", "direct", "mixed"])
@pytest.mark.parametrize("t", bpk.TILES)
@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("case", sorted(STRIDES) + ["integer landings"])
def test_every_tile_in_both_stride_regimes_and_at_whole_pixels(
        cuda, case, codec, t, stage):
    """Every compiled tile and wire type against the plain version where v
    moves ~2 and ~0.75 pixels a step of k, and where u and v land on whole
    and half pixels on and past the detector's edges (floor's edge
    cases); staged at the default budget, all gathered directly, and with
    a budget that stages some (tile, projection)s and not others. The
    kernel's direct count is the staging model's."""
    if case == "integer landings":
        params, nu, nv, shape = integer_landing_params(), 20, 16, (12, 10, 24)
    else:
        g, (lo, hi) = STRIDES[case]
        nu, nv, shape = g.n_u, g.n_v, (g.n_x, g.n_y, g.n_z)
        params, _ = kernel_operands(projection_matrices(g),
                                    torch.zeros(g.proj_shape()))
        # v's step a step of k at the volume's central column
        p = params[:, :12].double()
        ci, cj = g.n_x / 2, g.n_y / 2
        z = p[:, 8] * ci + p[:, 9] * cj + p[:, 11]
        step = float((p[:, 6] / z).abs().median())
        assert lo <= step <= hi
    q = torch.randn((params.shape[0], nv, nu),
                    generator=torch.Generator().manual_seed(5))
    data, scales = CODECS[codec].encode(q.to(cuda))
    params, qt = kernel_operands(params[:, :12].reshape(-1, 3, 4), data,
                                 scales)
    stage_bytes = {"default": None, "direct": 0,
                   "mixed": _mixed_stage_bytes(params, nu, nv, shape, t,
                                               qt.dtype)}[stage]
    if stage == "mixed":
        assert stage_bytes is not None
    got, moved = launch_counts(lambda: bpk.backproject_dual(
        params, qt, *shape, tile=t, stage_bytes=stage_bytes))
    want = bpk.backproject_dual_torch(params, qt, *shape)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max() / want.abs().max()) <= REL
    model = bpk.staging_stats(params, nu, nv, shape[0], shape[1],
                              shape[2] // 2, t, stage_bytes, qt.dtype)
    assert moved["direct_pairs"] == model["direct"]
    assert moved["tile_pairs"] == model["pairs"]


# One block of the default tile (8 x 8 columns, 33 < 128 values of k) and
# 24 projections, so that every ring wraps.
RING_G = CBCTGeometry(n_proj=24, n_u=48, n_v=140, d_u=0.1, d_v=0.05, d=4.0,
                      dsd=8.0, n_x=8, n_y=8, n_z=66, d_x=0.1, d_y=0.1,
                      d_z=0.02)


def _ring_operands(cuda, codec, g):
    q = torch.randn((g.n_proj, g.n_v, g.n_u),
                    generator=torch.Generator().manual_seed(11))
    data, scales = CODECS[codec].encode(q.to(cuda))
    return kernel_operands(projection_matrices(g), data, scales)


@pytest.mark.parametrize("codec", ["fp32", "fp16", "fp8_e4m3"])
def test_ring_depth_does_not_change_a_bit(cuda, codec):
    """Staging budgets at which the ring's copies run 1, 2, 3 and 4 steps
    ahead at worst (`ring_depths`), none of them gathering a projection
    directly: the same volume to the bit (the sum order does not follow
    the depth), within the plain version's bound.
    The wire types take bulk copies (f32), 8-byte (fp16) and 4-byte
    (fp8) cp.async copies at this detector's pitch."""
    g = RING_G
    shape = (g.n_x, g.n_y, g.n_z)
    params, qt = _ring_operands(cuda, codec, g)
    t = bpk.DEFAULT_TILE
    budgets = {}
    for px in range(256, 16384, 64):
        sb = px * qt.element_size()
        args = (params.cpu(), g.n_u, g.n_v, *shape[:2], g.n_z // 2, t, sb,
                qt.dtype)
        depth = bpk.ring_depths(*args).unique().tolist()
        if len(depth) == 1 and bpk.staging_stats(*args)["direct"] == 0:
            budgets.setdefault(depth[0], sb)
    assert {1, 2, 3, 4} <= set(budgets)
    vols = []
    for d in (1, 2, 3, 4):
        got, moved = launch_counts(lambda: bpk.backproject_dual(
            params, qt, *shape, tile=t, stage_bytes=budgets[d]))
        assert moved["direct_pairs"] == 0
        vols.append(got)
    want = bpk.backproject_dual_torch(params, qt, *shape)
    torch.cuda.synchronize()
    assert all(torch.equal(vols[0], v) for v in vols[1:])
    assert float((vols[0] - want).abs().max() / want.abs().max()) <= REL


@pytest.mark.parametrize("t", bpk.TILES)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_every_tile_through_a_wrapping_ring_with_direct_gathers(cuda, codec,
                                                                t):
    """Every tile and wire type over 20 projections with a budget that
    stages some (tile, projection)s and gathers others directly: every
    record is used at least twice, the staging wraps, and the sums are
    the plain version's."""
    g = dataclasses.replace(STRIDES["2px"][0], n_proj=20)
    shape = (g.n_x, g.n_y, g.n_z)
    params, qt = _ring_operands(cuda, codec, g)
    sb = _mixed_stage_bytes(params, g.n_u, g.n_v, shape, t, qt.dtype)
    assert sb is not None
    assert g.n_proj > 2 * bpk.records(t)
    got, moved = launch_counts(lambda: bpk.backproject_dual(
        params, qt, *shape, tile=t, stage_bytes=sb))
    want = bpk.backproject_dual_torch(params, qt, *shape)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= REL
    model = bpk.staging_stats(params, g.n_u, g.n_v, *shape[:2], g.n_z // 2,
                              t, sb, qt.dtype)
    assert moved["direct_pairs"] == model["direct"] > 0
    assert model["staged"] > 0


@pytest.mark.parametrize("stage_bytes", [None, 0])
def test_ring_waits_are_read_at_the_fence(cuda, stage_bytes):
    """The kernel's ring waits reach the fencing span's `ring_waits` arg
    and the registry, and count at most one a (warp, projection) step."""
    g = dataclasses.replace(STRIDES["2px"][0], n_proj=20)
    shape = (g.n_x, g.n_y, g.n_z)
    params, qt = _ring_operands(cuda, "fp32", g)
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        with tracer.span("test.ring") as sp:
            sp.fence(bpk.backproject_dual(params, qt, *shape,
                                          stage_bytes=stage_bytes))
    finally:
        set_tracer(prev)
    assert "ring_waits" in sp.args
    assert 0 <= sp.args["ring_waits"] <= 32 * sp.args["tile_pairs"]


@pytest.mark.parametrize("codec", ["fp32", "fp16"])
def test_measured_autotune_times_compiled_tiles(cuda, codec):
    pm = torch.as_tensor(projection_matrices(G), device=cuda)
    dtype = {"fp32": torch.float32, "fp16": torch.float16}[codec]
    tune.clear_cache()
    best = tune.autotune(G.n_x, G.n_y, G.n_z, pm, G.n_u, G.n_v,
                         qt_dtype=dtype, measure=True, max_measure=3)
    assert best.elapsed > 0 and best.tile in bpk.TILES
    assert best.smem <= tune.default_budget(cuda)
    # a measured winner satisfies the next unmeasured request, also
    # from the file after the memo is dropped
    tune.clear_cache()
    hits = tune.file_cache_hits()
    again = tune.autotune(G.n_x, G.n_y, G.n_z, pm, G.n_u, G.n_v,
                          qt_dtype=dtype)
    assert again == best and tune.file_cache_hits() == hits + 1


@pytest.mark.parametrize("codec", ["fp32", "fp16"])
def test_build_traced_matches_build_on_the_card(cuda, codec):
    proj = forward_project(G16, device=cuda)
    plan = ReconstructionPlan(geometry=G16, impl="kernel", precision=codec)
    want = plan.build()(proj)
    prev = set_tracer(Tracer(enabled=True))
    try:
        before = counted(bpk.LAUNCHES)
        got = plan.build_traced()(proj)
        torch.cuda.synchronize()
        tracer = set_tracer(prev)
    finally:
        set_tracer(prev)
    assert counted(bpk.LAUNCHES) == before + 1 and got.device.type == "cuda"
    assert float((got - want).abs().max() / want.abs().max()) <= REL
    stages = {e["name"] for e in tracer.spans("stage.")}
    assert stages == {"stage.filter", "stage.allgather",
                      "stage.backproject", "stage.reduce"}
    inc = dataclasses.replace(plan, schedule="incremental", n_steps=4)
    sess = inc.build_traced()
    for lo in range(0, 16, 4):
        vol = sess.update(proj[lo:lo + 4], (lo, lo + 4), finalize=lo == 12)
    assert float((vol - want).abs().max() / want.abs().max()) <= REL
    assert sess.stage_seconds()["stage.backproject"] > 0


def test_auto_plan_on_the_card_admits_the_kernel(cuda):
    from repro_torch.core.plan import plan_from_spec
    from repro_torch.planner import admitted_impls, search_plans
    assert admitted_impls(None, "cuda") == ("factorized", "kernel")
    props = search_plans(G16, None, top_k=None, calibration=None)
    assert {p.point.impl for p in props} == {"factorized", "kernel"}
    plan = plan_from_spec(G16, "auto,impl=kernel")
    assert plan.impl == "kernel" and plan.device == "cuda"
    vol = plan.build()(forward_project(G16, device=cuda))
    torch.cuda.synchronize()
    assert vol.shape == G16.volume_shape() and bool(vol.isfinite().all())


# The mesh engine's launch shapes: an x-slab (N_x/2 columns, P shifted to
# the second slab) and a y-chunk of it (N_y/4 rows, P shifted to the third
# chunk), as `slab_pmats` and `shift_pmats_j` hand them to the kernel.
MESH_CALLS = {"slab": (G.n_x // 2, G.n_y, 0),
              "y_chunk": (G.n_x // 2, G.n_y // 4, 2 * (G.n_y // 4))}


@pytest.mark.parametrize("call", sorted(MESH_CALLS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_kernel_matches_plain_version_on_mesh_shapes(cuda, codec, call):
    nx, ny, j0 = MESH_CALLS[call]
    pm = shift_pmats_j(
        shift_pmats_i(torch.from_numpy(projection_matrices(G)), float(nx)),
        float(j0))
    q = make_filter(G, device=cuda)(forward_project(G, device=cuda))
    data, scales = CODECS[codec].encode(q)
    params, qt = kernel_operands(pm, data, scales)
    got = bpk.backproject_dual(params, qt, nx, ny, G.n_z)
    want = bpk.backproject_dual_torch(params, qt, nx, ny, G.n_z)
    torch.cuda.synchronize()
    assert got.shape == (nx, ny, 2, G.n_z // 2)
    assert float((got - want).abs().max() / want.abs().max()) <= REL


def test_main_path_runs_the_kernel_and_matches_the_cpu(cuda):
    proj = forward_project(G, device="cpu")
    before = counted(bpk.LAUNCHES)
    vol = ReconstructionPlan(geometry=G, impl="kernel").build()(proj)
    torch.cuda.synchronize()
    assert counted(bpk.LAUNCHES) == before + 1
    assert vol.device.type == "cuda"
    ref = ReconstructionPlan(geometry=G, impl="kernel",
                             device="cpu").build()(proj)
    # the filter kernel and the CPU FFT differ at f32 round-off before the
    # back-projector
    rel = float((vol.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= REL


# -- the streaming, batched and I/O paths -------------------------------------

# G with 16 projections: 4 deltas of 4; and with RabbitCT's 496, which the
# filter's 32-projection batches do not divide.
G16 = dataclasses.replace(G, n_proj=16)
G496 = dataclasses.replace(G, n_proj=496)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_kernel_matches_plain_version_at_the_delta_shape(cuda, codec):
    """The incremental session's call: the whole volume from one delta
    (the last 4 of 16 projections), filtered and encoded alone."""
    proj = forward_project(G16, device=cuda)[12:]
    data, scales = CODECS[codec].encode(make_filter(G16, device=cuda)(proj))
    params, qt = kernel_operands(projection_matrices(G16)[12:], data, scales)
    got = bpk.backproject_dual(params, qt, *SHAPE)
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= REL


def test_session_of_four_deltas_matches_build(cuda):
    proj = forward_project(G16, device=cuda)
    ref = ReconstructionPlan(geometry=G16, impl="kernel").build()(proj)
    sess = ReconstructionPlan(geometry=G16, impl="kernel",
                              schedule="incremental",
                              n_steps=4).build_incremental()
    before = counted(bpk.LAUNCHES)
    for lo in range(0, 16, 4):
        sess.update(proj[lo:lo + 4], (lo, lo + 4))
    vol = sess.finalize()
    torch.cuda.synchronize()
    assert counted(bpk.LAUNCHES) == before + 4 and vol.device.type == "cuda"
    assert float((vol - ref).abs().max() / ref.abs().max()) <= REL


@pytest.mark.parametrize("codec,kw", [
    ("fp32", {}), ("fp16", {}),
    ("fp16", {"schedule": "pipelined", "n_steps": 8})])
def test_batched_lanes_bit_equal_at_496_projections(cuda, codec, kw):
    """The filter kernel filters every row alone, so each lane (the whole
    scan, or each micro-batch of 62) is filtered as build() filters it:
    lanes bit-equal to build()."""
    proj = forward_project(G496, device=cuda)
    plan = ReconstructionPlan(geometry=G496, impl="kernel", precision=codec,
                              **kw)
    out = plan.build_batched(2)(torch.stack([proj, proj * 1.5]))
    one = plan.build()
    assert torch.equal(out[0], one(proj))
    assert torch.equal(out[1], one(proj * 1.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_shard_store_round_trip_of_cuda_tensors(cuda, tmp_path, dtype):
    t = (torch.randn((6, 5, 4), device=cuda) * 4).to(dtype)
    save_array(str(tmp_path / "s"), t, chunks=(2, 1, 1))
    out = load_array(str(tmp_path / "s"))
    assert out.dtype == dtype and out.device.type == "cpu"
    assert torch.equal(out.view(torch.uint8), t.cpu().view(torch.uint8))
    assert read_manifest(str(tmp_path / "s"))["dtype"] == str(dtype).split(
        ".")[-1]


def test_encoded_source_and_write_behind_on_the_card(cuda, tmp_path):
    """An fp8 store written from projections on the card loads back onto
    the card as the codec's decode(encode()); a volume handed to the
    write-behind executor may be overwritten as soon as submit returns."""
    proj = forward_project(G16, device=cuda)
    src = ProjectionSource.write(str(tmp_path / "p"), proj, codec="fp8_e4m3")
    codec = CODECS["fp8_e4m3"]
    got = src.load(device=cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got, codec.decode(*codec.encode(proj)))
    vol = torch.full((32, 32, 32), 3.0, device=cuda)
    wb = AsyncWriteback()
    try:
        sink = VolumeSink(str(tmp_path / "v"))
        wb.submit(sink, vol)
        vol.fill_(-1.0)
        wb.drain()
    finally:
        wb.close()
    assert torch.equal(sink.read(), torch.full((32, 32, 32), 3.0))


# -- the ramp filter kernel ---------------------------------------------------

WINDOWS = ("ramlak", "shepp-logan", "hann", "hamming")
# RabbitCT's detector (the benchmark's cells), pad 4096.
RCT = CBCTGeometry(n_proj=496, n_u=1248, n_v=960, d_u=4.8 / 1248,
                   d_v=4.8 / 1248, d=4.0, dsd=8.0, n_x=512, n_y=512,
                   n_z=512, d_x=2 / 512, d_y=2 / 512, d_z=2 / 512)
# The small geometries: G (pad 128), an odd detector row, N_u = pad / 2,
# and a detector of one row.
FILTER_GEOMS = {"G": G, "odd": dataclasses.replace(G, n_u=41),
                "half": dataclasses.replace(G, n_u=64),
                "one-row": dataclasses.replace(G, n_v=1)}
# Two f32 transforms of length pad agree to a few ulps of the row's
# largest output times log2(pad) (measured ~2e-7 of the max on the CPU);
# 1e-5 of the max is the JAX package's own bound between two f32 FFTs
# (tests/test_torch_filtering.py), well above both.
FILTER_REL = 1e-5


def fft_chain(g, window, proj):
    """The torch.fft chain that filtered on the card before the kernel:
    `_filter_batch` a batch of 32 projections at a time."""
    pad = tfilt.fft_length(g.n_u)
    fcos = torch.as_tensor(tfilt.cosine_weights(g), device=proj.device)
    hf = torch.as_tensor(tfilt.ramp_frequency_response(g, window, pad),
                         device=proj.device)
    return torch.cat([tfilt._filter_batch(proj[b:b + 32], fcos, hf, pad,
                                          g.tau_u)
                      for b in range(0, proj.shape[0], 32)])


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def rct_projections(n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.rand((n, RCT.n_v, RCT.n_u), generator=gen, device=device)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("geom", sorted(FILTER_GEOMS))
def test_filter_kernel_matches_plain_version_and_fft_chain(cuda, geom,
                                                           window):
    g = FILTER_GEOMS[geom]
    proj = forward_project(g, device=cuda)
    before = counted(rfk.LAUNCHES)
    got = make_filter(g, window, device=cuda)(proj)
    assert counted(rfk.LAUNCHES) == before + 1
    plain = make_filter(g, window, device="cpu")(proj.cpu())
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert rel_max(got.cpu(), plain) <= FILTER_REL
    assert rel_max(got, fft_chain(g, window, proj)) <= FILTER_REL


@pytest.mark.parametrize("window", WINDOWS)
def test_filter_kernel_at_rabbitct(cuda, window):
    """All 496 x 960 rows against the torch.fft chain on the card; the
    first two projections also against the CPU's plain version and the
    kernel's torch twin."""
    proj = rct_projections(RCT.n_proj, cuda)
    got = make_filter(RCT, window, device=cuda)(proj)
    assert rel_max(got, fft_chain(RCT, window, proj)) <= FILTER_REL
    sub = proj[:2].clone()
    del proj
    plain = make_filter(RCT, window, device="cpu")(sub.cpu())
    assert rel_max(got[:2].cpu(), plain) <= FILTER_REL
    pad = tfilt.fft_length(RCT.n_u)
    fcos = torch.as_tensor(tfilt.cosine_weights(RCT), device=cuda)
    tables = rfk.filter_tables(tfilt._response(RCT, window, pad), RCT.tau_u,
                               cuda)
    twin = rfk.filter_rows_torch(sub, fcos, *tables)
    assert rel_max(got[:2], twin) <= FILTER_REL


def test_filter_kernel_rows_do_not_depend_on_the_batch(cuda):
    """One projection filtered alone is bit-equal to the same projection
    inside a batch of 32 and of 496."""
    proj = rct_projections(RCT.n_proj, cuda)
    filt = make_filter(RCT, device=cuda)
    whole, first, alone = filt(proj), filt(proj[:32]), filt(proj[5:6])
    assert torch.equal(alone[0], first[5]) and torch.equal(alone[0], whole[5])
    assert torch.equal(first, whole[:32])


def test_filter_kernel_counts_launches_and_rows(cuda):
    filt = make_filter(G, device=cuda)
    proj = forward_project(G, device=cuda)
    for _ in range(2):
        launches, rows = counted(rfk.LAUNCHES), counted(rfk.ROWS)
        filt(proj)
        assert counted(rfk.LAUNCHES) == launches + 1
        assert counted(rfk.ROWS) == rows + G.n_proj * G.n_v


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_filter_kernel_reads_16_bit_projections(cuda, dtype):
    """make_filter upcasts a 16-bit batch for the kernel, which reads f32:
    it filters bit-equal to its f32 upcast, and keeps the input dtype by
    default."""
    proj = forward_project(G, device=cuda).to(dtype)
    got = make_filter(G, out_dtype=torch.float32, device=cuda)(proj)
    assert torch.equal(got, make_filter(G, device=cuda)(proj.float()))
    assert make_filter(G, device=cuda)(proj).dtype == dtype


def test_filter_kernel_refuses_an_uncompiled_pad(cuda):
    g = dataclasses.replace(G, n_u=8)    # pad 16
    with pytest.raises(ValueError, match="compiled pad"):
        make_filter(g, device=cuda)(forward_project(g, device=cuda))


def test_wrapper_rejects_mixed_devices(cuda):
    params = torch.zeros((3, 13), device=cuda)
    qt = torch.zeros((3, 8, 6))
    with pytest.raises(ValueError, match="params13 on"):
        bpk.backproject_dual(params, qt, 4, 4, 4)


# -- the flash-attention kernel ----------------------------------------------

F32_TOL = 2e-5   # rtol = atol, the reference kernel's own f32 bound
BF16_TOL = 0.02  # max abs, the reference kernel's bf16 bound


def _qkv(bh, kvh, sq, sk, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device=device, dtype=dtype)
        for shape in ((bh, sq, d), (kvh, sk, d), (kvh, sk, d)))


# MHA at a tile multiple, GQA with a ragged S, MQA with D = 16 (padded to
# 64 in the kernel), cross lengths, the serving head dim, the serving shape
# (48 query heads over 8), and S ragged around one and many 64-row tiles;
# then head dims that are not a multiple of 8, one query and one key, GQA
# groups of 6, and the serving head dim ragged around the f32 kernel's
# 128-row tile; then Qwen2-MoE's prefill shape, 4 requests x 16 heads over
# 16 (group 1), and the Jamba pattern's, 4 x 64 heads over 8 (group 8), at
# S = 2048; last DeepSeek-Coder-33B's 56 heads over 8 (group 7) with a
# ragged S.
ATTN_SHAPES = [(4, 4, 128, 128, 64), (8, 2, 200, 200, 128),
               (6, 1, 77, 77, 16), (4, 2, 96, 160, 32), (2, 2, 64, 64, 128),
               (48, 8, 2048, 2048, 128), (6, 2, 65, 65, 128),
               (6, 2, 2047, 2047, 128), (4, 2, 100, 100, 12),
               (6, 1, 130, 130, 36), (12, 2, 200, 200, 100),
               (4, 4, 1, 1, 64), (6, 1, 1, 1, 128), (12, 2, 70, 70, 128),
               (64, 64, 2048, 2048, 128), (256, 32, 2048, 2048, 128),
               (56, 8, 300, 300, 128)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_version(cuda, shape, causal, dtype):
    q, k, v = _qkv(*shape, dtype, cuda)
    before = counted(fak.LAUNCHES)
    got = fak.flash_attention_bhsd(q, k, v, causal=causal)
    assert counted(fak.LAUNCHES) == before + 1
    want = fak.flash_attention_bhsd_torch(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert float((got.float() - want.float()).abs().max()) < BF16_TOL


STRESS = 3.0  # q and k scaled: a peaked softmax amplifies score errors


def _stressed(q, k, v):
    return q * STRESS, k * STRESS, v


@pytest.mark.parametrize("shape", [(8, 2, 200, 200, 128),
                                   (6, 1, 130, 130, 36),
                                   (4, 2, 100, 100, 12)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_f32_kernel_stressed_matches_the_exact_function(
        cuda, shape, causal):
    """q and k scaled by 3; a kernel that dropped the 3xTF32 lo terms would
    miss the bound by far (tests/test_torch_attention.py). The reference
    is the function in f64: at D = 128 the plain version's own f32 sums
    sit up to ~2e-5 from it here, the whole bound, and the kernel is also
    held no farther from it than the plain version. With shorter sums
    (d < 128) the plain version sits a few 1e-6 from it, closer than three
    TF32 products can come, and the kernel is also held to the plain
    version at the f32 bound, as every unstressed case is."""
    q, k, v = _stressed(*_qkv(*shape, torch.float32, cuda, seed=3))
    exact = attention_f64(q, k, v, causal)
    got = fak.flash_attention_bhsd(q, k, v, causal=causal).double()
    plain = fak.flash_attention_bhsd_torch(q, k, v, causal=causal).double()
    torch.testing.assert_close(got, exact, rtol=F32_TOL, atol=F32_TOL)
    if shape[-1] == 128:
        assert (got - exact).abs().max() <= (plain - exact).abs().max()
    else:
        torch.testing.assert_close(got, plain, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_f32_kernel_stressed_at_the_serving_shape(cuda, causal):
    """Stressed at 48 heads over 8, S = 2048, D = 128. There the plain
    version's own f32 sums sit ~3e-5 from the exact function, so both are
    held to its f64 evaluation: the kernel within the f32 bound, and no
    farther from it than the plain version."""
    q, k, v = _stressed(*_qkv(48, 8, 2048, 2048, 128, torch.float32, cuda))
    exact = attention_f64(q, k, v, causal)
    got = fak.flash_attention_bhsd(q, k, v, causal=causal).double()
    plain = fak.flash_attention_bhsd_torch(q, k, v, causal=causal).double()
    torch.testing.assert_close(got, exact, rtol=F32_TOL, atol=F32_TOL)
    assert (got - exact).abs().max() <= (plain - exact).abs().max()


def test_attention_gqa_matches_the_reference_oracle(cuda):
    """The (B, S, H, D) wrapper reads KV head h // (H/K), as the repeat."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda) for s in ((2, 130, 6, 32), (2, 130, 2, 32),
                                   (2, 130, 2, 32)))
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_attention_build_failure_raises(cuda, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cu"
    bad.write_text("this is not CUDA C++\n")
    monkeypatch.setattr(fak, "LIBRARY", CudaLibrary("broken", [bad]))
    q, k, v = _qkv(2, 2, 64, 64, 32, torch.float32, cuda)
    before = counted(fak.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fak.flash_attention_bhsd(q, k, v)
    assert counted(fak.LAUNCHES) == before


def test_attention_rejects_unsupported_head_dim(cuda):
    q, k, v = _qkv(2, 2, 64, 64, 130, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dims"):
        fak.flash_attention_bhsd(q, k, v)


# -- the serving path --------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to(v, device) for k, v in tree.items()}


def test_greedy_generate_on_the_card_runs_the_kernel(cuda):
    """A 2-layer smoke model in f32: on the card every prefill layer
    launches the kernel (a 37-token prompt, ragged for its 64-row tiles,
    head dim 16), and the ids match the CPU's plain attention step."""
    cfg = get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 37)))
    want = greedy_generate(cfg, params, {"tokens": tokens}, steps=5,
                           s_max=48)
    before = counted(fak.LAUNCHES)
    got = greedy_generate(cfg, _to(params, cuda),
                          {"tokens": tokens.to(cuda)}, steps=5, s_max=48)
    torch.cuda.synchronize()
    assert counted(fak.LAUNCHES) == before + cfg.num_layers
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_prefill_kernel_path_matches_the_plain_step_on_the_card(
        cuda, monkeypatch):
    """f32: the kernel path and the plain attention step differ only by
    summation order (1e-5 of the largest |value|, for the logits and for
    the second layer's cache, which sees the first layer's attention)."""
    cfg = get_smoke_config("yi_6b").scaled(dtype="float32", head_dim=32)
    params = init_params(cfg, seed=1, device=cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 70))
    ).to(cuda)
    got, cache = prefill(params, cfg, {"tokens": tokens})
    monkeypatch.setattr(layers, "prefill_attention",
                        layers.prefill_attention_plain)
    before = counted(fak.LAUNCHES)
    want, want_cache = prefill(params, cfg, {"tokens": tokens})
    assert counted(fak.LAUNCHES) == before
    for g, w in ((got, want), (cache.attn_v["sub_0"],
                               want_cache.attn_v["sub_0"])):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_kernel_step_refuses_what_its_mask_cannot_express(cuda):
    """On the card the prefill step masks by index: positions other than
    0..S-1 raise instead of computing another mask (with or without a
    window)."""
    cfg = get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    q = torch.zeros((1, 8, cfg.num_heads, 16), device=cuda)
    k = torch.zeros((1, 8, cfg.num_kv_heads, 16), device=cuda)
    pos = torch.arange(8, device=cuda)[None]
    for c in (cfg, cfg.scaled(sliding_window=4)):
        with pytest.raises(ValueError, match="0..S-1"):
            layers.prefill_attention(c, q, k, k, pos + 3)


# (query rows, KV rows, S, D, window): group 4 with S and the window ragged
# for the 64-key tiles; group 7 (DeepSeek-Coder-33B's 56 over 8); DP = 64
# (MusicGen's head dim, MHA); a window of 1 (the diagonal alone); a window
# of exactly one tile; Mixtral's 32 over 8 at S = 2 x its window.
WINDOW_SHAPES = [(8, 2, 300, 128, 100), (56, 8, 520, 128, 200),
                 (32, 32, 400, 64, 130), (4, 1, 130, 64, 1),
                 (8, 2, 256, 128, 64), (32, 8, 8192, 128, 4096)]


@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_matches_plain_version(cuda, shape, dtype):
    bh, kvh, s, d, window = shape
    q, k, v = _qkv(bh, kvh, s, s, d, dtype, cuda, seed=window)
    before = counted(fak.LAUNCHES)
    got = fak.flash_attention_bhsd(q, k, v, window=window)
    assert counted(fak.LAUNCHES) == before + 1
    want = fak.flash_attention_bhsd_torch(q, k, v, window=window)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        exact = attention_f64(q, k, v, window=window)
        torch.testing.assert_close(got.double(), exact, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert float((got.float() - want.float()).abs().max()) < BF16_TOL
        # BF16_TOL is about a typical output at S = 8192, too loose to see
        # a key missed or let in at the window's lower edge.
        exact = attention_f64(q, k, v, window=window)
        assert within_plain_rounding(got, want, exact), (
            f64_distances(got, exact), f64_distances(want, exact))


def test_window_wider_than_s_is_bit_equal_to_causal(cuda):
    q, k, v = _qkv(8, 2, 300, 300, 128, torch.bfloat16, cuda, seed=9)
    torch.testing.assert_close(fak.flash_attention_bhsd(q, k, v, window=300),
                               fak.flash_attention_bhsd(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch,s0,s_max", [("mixtral_8x7b", 45, 50),
                                           ("mixtral_8x7b", 20, 26),
                                           ("musicgen_large", 37, 42),
                                           ("internvl2_26b", 37, 50)])
def test_new_configs_greedy_generate_on_the_card(cuda, arch, s0, s_max):
    """Mixtral's smoke model (window 32) longer than its window (the
    windowed kernel, a ring of 32 slots) and shorter; MusicGen's codes and
    InternVL2's 8 image positions before the text. One launch per layer of
    the prefill; the ids match the CPU's plain step."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    fe = cfg.frontend
    shape = (3, fe.num_positions, s0) if arch == "musicgen_large" else (3, s0)
    prompt = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      shape))}
    if arch == "internvl2_26b":
        prompt["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (3, fe.num_positions, fe.d_frontend), dtype=np.float32))
    want = greedy_generate(cfg, params, prompt, steps=5, s_max=s_max)
    before = counted(fak.LAUNCHES)
    got = greedy_generate(cfg, _to(params, cuda), _to(prompt, cuda),
                          steps=5, s_max=s_max)
    torch.cuda.synchronize()
    assert counted(fak.LAUNCHES) == before + cfg.num_layers
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# -- MoE, SSM and hybrid layers on the card ----------------------------------

def _family(arch):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _close_to(got, want, rel=1e-5):
    """Plain torch on both devices: only the summation order differs."""
    got = got.detach().cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "jamba_1_5_large"])
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_on_the_card_matches_the_cpu(cuda, arch, capacity_factor):
    """f32 routing stays f32 on the card (the same experts and drops) and
    the output and aux within 1e-5 of the max of the CPU's."""
    from repro_torch.models.moe import moe, route
    cfg, params = _family(arch)
    if capacity_factor is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    p = params["blocks"]["sub_1" if arch == "jamba_1_5_large"
                         else "sub_0"]["moe"]
    p = {k: (v[0] if isinstance(v, torch.Tensor) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32))
    want, want_aux = moe(p, cfg, x)
    got, aux = moe(_to(p, cuda), cfg, x.to(cuda))
    r_cpu, r_card = route(p, cfg, x), route(_to(p, cuda), cfg, x.to(cuda))
    assert torch.equal(r_card.gate_idx.cpu(), r_cpu.gate_idx)
    assert torch.equal(r_card.keep.cpu(), r_cpu.keep)
    _close_to(got, want)
    _close_to(aux, want_aux)


def test_ssm_block_on_the_card_matches_the_cpu(cuda):
    """Chunked over 40 tokens (a padded tail), the prefill's cache, and a
    decode step from it: within 1e-5 of the max of the CPU's."""
    from repro_torch.models.ssm import ssm_block
    cfg, params = _family("mamba2_130m")
    p = {k: v[0] for k, v in params["blocks"]["sub_0"]["ssm"].items()}
    rng = np.random.default_rng(3)
    for name in ("conv_b", "a_log", "d_skip", "dt_bias", "norm"):
        p[name] = torch.from_numpy(0.5 * rng.standard_normal(
            p[name].shape, dtype=np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 41, cfg.d_model),
                                             dtype=np.float32))
    want, want_c = ssm_block(p, cfg, u[:, :40], return_cache=True)
    got, got_c = ssm_block(_to(p, cuda), cfg, u[:, :40].to(cuda),
                           return_cache=True)
    for g, w in ((got, want), (got_c.conv, want_c.conv),
                 (got_c.state, want_c.state)):
        _close_to(g, w)
    want, want_c = ssm_block(p, cfg, u[:, 40:], cache=want_c)
    got, got_c = ssm_block(_to(p, cuda), cfg, u[:, 40:].to(cuda),
                           cache=got_c)
    for g, w in ((got, want), (got_c.conv, want_c.conv),
                 (got_c.state, want_c.state)):
        _close_to(g, w)


@pytest.mark.parametrize("arch,per_prefill", [("qwen2_moe_a2_7b", 2),
                                              ("mamba2_130m", 0),
                                              ("jamba_1_5_large", 1)])
def test_family_greedy_generate_on_the_card(cuda, arch, per_prefill):
    """Each attention sub-layer of a prefill launches the kernel once (the
    Mamba-2 stack has none); the ids match the CPU's plain step."""
    cfg, params = _family(arch)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 37)))
    want = greedy_generate(cfg, params, {"tokens": tokens}, steps=5,
                           s_max=48)
    before = counted(fak.LAUNCHES)
    got = greedy_generate(cfg, _to(params, cuda), {"tokens": tokens.to(cuda)},
                          steps=5, s_max=48)
    torch.cuda.synchronize()
    assert counted(fak.LAUNCHES) == before + per_prefill
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# -- training on the card -------------------------------------------------

def test_raw_attention_wrapper_raises_under_grad(cuda):
    """The kernel writes outside autograd: the raw wrapper refuses operands
    that require grad while grad is enabled, and launches under no_grad."""
    q, k, v = _qkv(8, 2, 64, 64, 32, torch.bfloat16, cuda)
    q.requires_grad_()
    before = counted(fak.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        fak.flash_attention_bhsd(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_trainable"):
        flash_attention(q.view(1, 8, 64, 32).transpose(1, 2),
                        k.view(1, 2, 64, 32).transpose(1, 2),
                        v.view(1, 2, 64, 32).transpose(1, 2))
    assert counted(fak.LAUNCHES) == before
    with torch.no_grad():
        fak.flash_attention_bhsd(q, k, v)
    assert counted(fak.LAUNCHES) == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainable_attention_gradients_bit_equal_on_the_card(cuda, dtype):
    """The Function's forward is the kernel (one launch, within the
    kernel's bounds of the dense oracle); dq, dk, dv are bit-equal to
    autograd through the plain step with the same dO, called directly and
    through the layer's attention step (S = 200, ragged for the tiles)."""
    cfg = get_smoke_config("qwen2_1_5b")
    h, kh, hd, s = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 200
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda, dtype)
    q, k, v, d_out = t(2, s, h, hd), t(2, s, kh, hd), t(2, s, kh, hd), \
        t(2, s, h, hd)
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(2, s)

    def plain(q, k, v):
        return layers.prefill_attention_plain(cfg, q, k, v, pos)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(plain(*ref), ref, d_out)
    for step in (lambda *a: flash_attention_trainable(*a, plain=plain),
                 lambda *a: layers.prefill_attention(cfg, *a, pos)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = counted(fak.LAUNCHES)
        out = step(*leaves)
        got = torch.autograd.grad(out, leaves, d_out)
        torch.cuda.synchronize()
        assert counted(fak.LAUNCHES) == before + 1
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
        oracle = attention_ref(q, k, v)
        if dtype == torch.float32:
            torch.testing.assert_close(out.detach(), oracle, rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            assert float((out.detach().float() - oracle.float()).abs().max()
                         ) < BF16_TOL


def _fan_in_scaled(params, cfg):
    """Block weights at std 1 / sqrt(fan_in), as tests/test_torch_training.py
    draws them (the stacked init's one-hot softmax magnifies round-off)."""
    from repro_torch.models.transformer import _sublayer_defs
    with torch.no_grad():
        for i, sub in enumerate(cfg.pattern):
            block = params["blocks"][f"sub_{i}"]
            for name, defs in _sublayer_defs(cfg, sub).items():
                for key, d in defs.items():
                    block[name][key].mul_(
                        (cfg.repeats / (d.fan_in or d.shape[0])) ** 0.5)


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """Two f32 steps of a 2-layer model, 2 micro-batches: on the card each
    step launches the kernel 2 layers x 2 (remat) x 2 micro-batches times,
    and its metrics and params are within the CPU parity test's bounds of
    the same steps on the CPU."""
    cfg = get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    cpu = init_train_state(cfg, seed=0, device="cpu")
    _fan_in_scaled(cpu.params, cfg)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().numpy().copy()
    card = train_state_from_reference(
        (host(cpu.params), (cpu.opt.step.numpy(), host(cpu.opt.mu),
                            host(cpu.opt.nu))), cfg, device=cuda)
    step = make_train_step(cfg, microbatches=2, warmup=2, total_steps=16)
    rng = np.random.default_rng(8)
    opt = AdamWConfig()
    for _ in range(2):
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 24)).astype(np.int32))
            for k in ("labels", "tokens")}
        cpu, want = step(cpu, batch)
        before = counted(fak.LAUNCHES)
        card, got = step(card, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert counted(fak.LAUNCHES) == before + 2 * 2 * 2
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        move = 2 * opt.lr * float(want["lr_scale"])
        flat_cpu, flat_card = host(cpu.params), host(_to(card.params, "cpu"))
        for (pa, a), (pb, b) in zip(_leaves_of(flat_cpu),
                                    _leaves_of(flat_card)):
            assert pa == pb and np.abs(a - b).max() <= move, pa
    assert int(card.opt.step) == int(cpu.opt.step) == 2


def _leaves_of(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_of(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# -- the service, checkpoints and the resumable reconstruction on the card

def test_service_lanes_bit_equal_to_build_on_the_card(cuda, tmp_path):
    """3 in-memory scans and a stored fp16 scan with a sink, impl="kernel",
    at default_geometry(64): each volume bit-equal to its family plan's
    build(), the sink's store equal to the volume; the one bucket launches
    the kernel at least once for each of its 4 lanes."""
    from repro_torch.core.geometry import default_geometry
    from repro_torch.service import ReconstructionService, TicketState
    g = default_geometry(64)
    proj = forward_project(g, device=cuda)
    scans = [proj, proj * 1.5, proj * 0.5]
    src = ProjectionSource.write(str(tmp_path / "p"), proj, codec="fp16")
    sink = VolumeSink(str(tmp_path / "v"))
    svc = ReconstructionService(max_batch=4)
    try:
        assert svc.device.type == "cuda"
        before = counted(bpk.LAUNCHES)
        tickets = [svc.submit(projections=p, geometry=g, impl="kernel")
                   for p in scans]
        tickets.append(svc.submit(source=src, geometry=g, sink=sink,
                                  impl="kernel"))
        svc.drain()
        assert all(t.state is TicketState.DONE for t in tickets)
        assert counted(bpk.LAUNCHES) - before >= 4
        build = svc.plan_cache.resolve(tickets[0].family).build()
        for p, t in zip(scans + [src.load(device=cuda)], tickets):
            assert t.result().device.type == "cuda"
            assert torch.equal(build(p), t.result())
        assert torch.equal(sink.read(), tickets[-1].result().cpu())
        st = svc.stats()
        assert st["buckets"] == 1 and "padded_lanes" not in st
        assert st["plan_cache"]["searches"] == 1
    finally:
        svc.close()


def test_serve_loop_on_the_card(cuda):
    """serve() launches from its own thread on the card; wait() then the
    volumes bit-equal to build()."""
    from repro_torch.service import ReconstructionService
    proj = forward_project(G16, device=cuda)
    svc = ReconstructionService(max_batch=2).serve()
    try:
        tickets = [svc.submit(projections=proj * (1 + k), geometry=G16,
                              impl="kernel", deadline_s=60.0)
                   for k in range(3)]
        for t in tickets:
            assert t.wait(timeout=120.0) and t.done
        build = svc.plan_cache.resolve(tickets[0].family).build()
        for k, t in enumerate(tickets):
            assert torch.equal(build(proj * (1 + k)), t.result())
        svc.shutdown()
        st = svc.stats()
        assert st["loop"]["errors"] == 0 and st["slo"]["met"] == 3
    finally:
        svc.close()


def test_traced_bucket_on_the_card(cuda):
    """A traced bucket of three host scans under max_batch 4, impl="kernel"
    and the fused schedule (one launch a lane): the engine runs 3 lanes,
    its span's stage times come from CUDA events (the launch inside its
    back-projection stage, both inside the span), it carries the
    launches' direct and tile pair counts the registry advanced by, the
    bucket span has no device work of its own, and each lane copy carries
    its bytes."""
    from repro_torch.service import ReconstructionService
    proj = forward_project(G16, device="cpu")
    svc = ReconstructionService(max_batch=4)
    # the family's plan resolved (and the planner's measured launches
    # made) before the traced drain
    pins = {"impl": "kernel", "schedule": "fused"}
    svc.submit(projections=proj, geometry=G16, **pins)
    svc.drain()
    names = (bpk.LAUNCHES, bpk.TILE_PAIRS, bpk.DIRECT_PAIRS)
    before = [counted(n) for n in names]
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        tickets = [svc.submit(projections=proj * (1 + k), geometry=G16,
                              **pins) for k in range(3)]
        svc.drain()
    finally:
        set_tracer(prev)
        svc.close()
    assert all(t.done for t in tickets)
    assert svc.plan_cache.resolve(tickets[0].family).schedule == "fused"
    launches, pairs, direct = (counted(n) - b for n, b in zip(names, before))
    (eng,) = tracer.spans("engine.batched")
    args = eng["args"]
    assert args["lanes"] == 3 == launches
    ms = args["device_ms"]
    assert sorted(ms) == ["bp.kernel", "bp.operands", "bp.unfold",
                          "filter.kernel", "stage.backproject",
                          "stage.filter", "stage.reduce"]
    assert 0 < ms["bp.kernel"] <= ms["stage.backproject"] <= eng["dur"] / 1e3
    assert 0 < ms["filter.kernel"] <= ms["stage.filter"]
    assert (args["tile_pairs"], args["direct_pairs"]) == (pairs, direct)
    assert pairs > 0 and 0 <= direct <= pairs
    (bucket,) = [e for e in tracer.spans("service.bucket")
                 if e["name"] == "service.bucket"]
    assert bucket["args"]["scans"] == 3
    assert "pads" not in bucket["args"]
    assert "device_ms" not in bucket["args"]
    h2d = tracer.spans("service.lane.h2d")
    assert [e["args"]["bytes"] for e in h2d] == [proj.numel() * 4] * 3
    assert {e["args"]["src"] for e in h2d} == {"host"}


def test_service_budget_defaults_to_the_card_memory(cuda):
    from repro_torch.planner import DEFAULT_HBM_BYTES
    from repro_torch.service import ReconstructionService
    svc = ReconstructionService()
    try:
        total = torch.cuda.get_device_properties(cuda).total_memory
        assert svc.hbm_bytes == total != DEFAULT_HBM_BYTES
    finally:
        svc.close()


def test_bare_defaults_answer_for_the_card(cuda):
    from repro_torch.planner import admitted_impls
    assert admitted_impls() == ("factorized", "kernel")
    assert tune.default_budget() == tune.default_budget(cuda) >= 48 * 1024


def test_resumable_reconstruction_on_the_card(cuda, tmp_path):
    """Micro-batches folded through the kernel by the session's stage and
    fold, killed at batch 3 and resumed from the checkpoint onto the card:
    bit-equal to an uninterrupted run, and within 1e-5 of build()."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.fdk import fdk_scale
    from repro_torch.runtime import ResumableReconstruction
    proj = forward_project(G16, device=cuda)
    plan = ReconstructionPlan(geometry=G16, impl="kernel", precision="fp32",
                              schedule="incremental", n_steps=4)
    sess = plan.build_incremental()

    def step(acc, b):
        s = sess.stage(proj[4 * b:4 * b + 4], (4 * b, 4 * b + 4))
        sess._acc = acc
        sess._fold(s.pm_col, s.q_col, s.sc_col)
        return sess._acc

    zeros = torch.zeros(G16.volume_shape(), device=cuda)
    want = ResumableReconstruction(step, zeros, 4).run()
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="injected"):
        ResumableReconstruction(step, zeros, 4, mgr,
                                checkpoint_every=2).run(fail_at=3)
    r = ResumableReconstruction(step, zeros, 4, mgr, checkpoint_every=2)
    r.resume()
    assert r.state.cursor == 2 and r.state.accumulator.device.type == "cuda"
    got = r.run()
    assert torch.equal(got, want)
    ref = ReconstructionPlan(geometry=G16, impl="kernel",
                             precision="fp32").build()(proj)
    vol = got * fdk_scale(G16)
    assert float((vol - ref).abs().max() / ref.abs().max()) <= REL


def test_rabbitct_stream_served_matches_the_fused_engine(cuda):
    """A RabbitCT scan streamed through the service in the benchmark
    cell's plan, 8 deltas of 62 projections pushed from this thread and
    folded by the serve loop: one back-projection and one filter launch a
    delta, and the volume within the cell's limits (rel_rmse 1.2e-05,
    max_rel_err 1.2e-04) of the fused engine's."""
    from repro_torch.service import ReconstructionService
    proj = forward_project(RCT, device=cuda)
    spec = ("impl=kernel,precision=fp32,schedule=incremental,"
            "window=ramlak,reduce=psum,n_steps=8")
    svc = ReconstructionService(spec=spec).serve()
    names = (bpk.LAUNCHES, rfk.LAUNCHES)
    try:
        ticket = svc.open_stream(geometry=RCT)
        before = [counted(n) for n in names]
        for lo in range(0, RCT.n_proj, 62):
            svc.push(ticket, proj[lo:lo + 62], (lo, lo + 62))
        assert ticket.wait(timeout=300) and ticket.done, ticket.error
        assert [counted(n) - b for n, b in zip(names, before)] == [8, 8]
        vol = ticket.result()
        st = svc.stats()["streams"]
        assert (st["open"], st["deltas"], st["resident_bytes"]) == (0, 8, 0)
    finally:
        svc.close()
    ref = ReconstructionPlan(geometry=RCT, impl="kernel",
                             precision="fp32").build()(proj)
    d = vol - ref
    assert float(d.norm() / ref.norm()) <= 1.2e-5
    assert float(d.abs().max() / ref.abs().max()) <= 1.2e-4
