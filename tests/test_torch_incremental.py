"""Port parity for the streaming session: `repro_torch.core.plan`'s
`IncrementalSession` (`build_incremental`, `update`, `stage`, `poll`,
`finalize`) against `repro.core.plan`'s.

The same numpy deltas, folded in order, give volumes within 1e-5 of the
max of the JAX session's for every impl x {fp32, bf16, fp8_e4m3}; for bf16
the two packages' filters differ by f32 round-off, which flips a few bf16
roundings, and each flipped value moves a voxel by at most its weight
(bound computed below). The reference's own contracts hold on the port:
in-order folding is bit-equal to the port's fused engine for
reference/factorized, any order bit-equal to the fused fold of the
permuted stream, the kernel within 5e-6; staged = raw;
update(finalize=True) = finalize(); the guards raise the reference's
messages. The discovery loop (writer -> poll -> finalize -> sink) closes
it.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro.core import precision as jprec
from repro_torch.core import plan as tplan
from repro_torch.core.backprojection import backproject_reference
from repro_torch.core.fdk import fdk_scale
from repro_torch.core.filtering import filter_projections, make_filter
from repro_torch.core.geometry import CBCTGeometry, projection_matrices
from repro_torch.core.precision import Precision
from repro_torch.io.streams import (
    ProjectionSource, StreamingProjectionWriter, VolumeSink,
)

torch.set_num_threads(1)

JG = jgeo.default_geometry(16, n_proj=16)
G = CBCTGeometry(**dataclasses.asdict(JG))
DELTAS = [(0, 4), (4, 8), (8, 12), (12, 16)]
REL = 1e-5
KERNEL_REL = 5e-6      # tests/test_streaming.py's reassociation bound


@functools.lru_cache(maxsize=None)
def projections():
    return np.array(jph.forward_project(JG))


def session(n_steps=4, pkg=tplan, **kw):
    if pkg is tplan:
        kw["device"] = "cpu"
        geom = G
    else:
        geom = JG
    return pkg.ReconstructionPlan(geometry=geom, schedule="incremental",
                                  n_steps=n_steps, **kw).build_incremental()


def fold(sess, order=range(4)):
    proj = projections()
    for k in order:
        lo, hi = DELTAS[k]
        sess.update(proj[lo:hi], (lo, hi))
    return np.asarray(sess.finalize())


def fused(**kw):
    return tplan.ReconstructionPlan(geometry=G, device="cpu", **kw).build()(
        projections()).numpy()


def bf16_flip_bound() -> float:
    """Most a voxel can move between the two packages' bf16 volumes: for
    each projection, the largest difference of the two bf16 streams times
    the largest weight 1/z^2 over the volume (z is affine in the voxel
    index, so its least value is at a corner; the bilinear weights sum to
    1), summed over projections, times the FDK scale."""
    proj = projections()
    codec = Precision("bf16").codec
    jq = np.asarray(jprec.Precision("bf16").codec.encode(
        jfilt.make_filter(JG, out_dtype=np.float32)(proj))[0]).astype(
            np.float32)
    tq = codec.encode(make_filter(G, out_dtype=torch.float32, device="cpu")(
        torch.from_numpy(proj)))[0].float().numpy()
    dq = np.abs(jq - tq).reshape(G.n_proj, -1).max(axis=1)
    pm = projection_matrices(G).astype(np.float64)
    corners = np.array(list(itertools.product(
        (0, G.n_x - 1), (0, G.n_y - 1), (0, G.n_z - 1))), np.float64)
    z = corners @ pm[:, 2, :3].T + pm[:, 2, 3]
    return fdk_scale(G) * float(((1.0 / z.min(axis=0) ** 2) * dq).sum())


@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp8_e4m3"])
@pytest.mark.parametrize("impl", ["reference", "factorized", "kernel"])
def test_session_matches_jax_session(impl, codec):
    got = fold(session(impl=impl, precision=codec))
    want = fold(session(pkg=jplan, impl=impl, precision=codec))
    err = float(np.max(np.abs(got - want)))
    bound = REL * float(np.max(np.abs(want)))
    if codec == "bf16":
        bound += bf16_flip_bound()
    assert err <= bound, f"{impl}/{codec}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("impl,codec", [
    ("reference", "fp32"), ("factorized", "fp32"), ("factorized", "bf16"),
    ("factorized", "fp8_e4m3"), ("reference", "fp16")])
def test_in_order_is_bit_equal_to_fused(impl, codec):
    """In-order folding continues the fused engine's per-voxel addition
    sequence (`init=` threading): bit for bit, the codecs included."""
    np.testing.assert_array_equal(
        fold(session(impl=impl, precision=codec)),
        fused(impl=impl, precision=codec))


def test_any_order_is_the_permuted_fused_stream():
    order = [2, 0, 3, 1]
    vol = fold(session(impl="reference"), order)
    perm = np.concatenate([np.arange(*DELTAS[k]) for k in order])
    q = filter_projections(G, torch.from_numpy(projections()))[perm]
    pm = torch.from_numpy(projection_matrices(G))[perm]
    want = backproject_reference(pm, q, G.n_x, G.n_y, G.n_z) * fdk_scale(G)
    np.testing.assert_array_equal(vol, want.numpy())
    ref = fused()
    assert np.max(np.abs(vol - ref)) / np.max(np.abs(ref)) < KERNEL_REL


def test_kernel_folds_acc_plus_bp_within_reassociation():
    ref = fused(impl="kernel")
    vol = fold(session(impl="kernel"))
    assert np.max(np.abs(vol - ref)) / np.max(np.abs(ref)) < KERNEL_REL


def test_staged_equals_raw_and_the_fused_epilogue_equals_finalize():
    proj = projections()
    sess = session()
    for lo, hi in DELTAS[:3]:
        staged = sess.stage(proj[lo:hi], (lo, hi))
        assert isinstance(staged, tplan.StagedDelta)
        assert sess.n_folded == lo     # stage is pure
        sess.update(staged)
    vol = sess.update(sess.stage(proj[12:], (12, 16)), finalize=True)
    np.testing.assert_array_equal(vol.numpy(), fused())
    np.testing.assert_array_equal(sess.finalize().numpy(), vol.numpy())
    one = session(n_steps=1).update(proj, (0, 16), finalize=True)
    np.testing.assert_array_equal(one.numpy(), fused())


def test_partial_peek_keeps_the_session_open():
    proj = projections()
    sess = session(n_steps=2)
    sess.update(proj[:8], slice(0, 8))
    peek = sess.finalize(partial=True)
    assert torch.isfinite(peek).all() and sess.n_folded == 8
    assert sess.pending_ranges() == [(8, 16)]
    sess.update(proj[8:], (8, None))
    assert sess.is_complete and sess.pending_ranges() == []


def guard_messages(pkg):
    """The error of each misuse, from a session of `pkg`."""
    proj = projections()
    out = []

    def catch(exc, fn):
        with pytest.raises(exc) as e:
            fn()
        out.append(str(e.value))

    s = session(pkg=pkg)
    s.update(proj[:4], (0, 4))
    catch(ValueError, lambda: s.update(proj[:4], (0, 4)))
    staged = s.stage(proj[4:8], (4, 8))
    s.update(proj[4:8], (4, 8))
    catch(ValueError, lambda: s.update(staged))
    catch(TypeError, lambda: s.update(staged, (4, 8)))
    catch(ValueError, lambda: s.update(proj[:4], (12, 20)))
    catch(ValueError, lambda: s.update(proj[:4], (8, 16)))
    catch(TypeError, lambda: s.update(proj[:4]))
    catch(ValueError, lambda: s.update(proj[:4], slice(8, 16, 2)))
    catch(ValueError, s.finalize)
    catch(TypeError, s.poll)
    geom = G if pkg is tplan else JG
    kw = {"device": "cpu"} if pkg is tplan else {}
    catch(ValueError, lambda: pkg.ReconstructionPlan(
        geometry=geom, schedule="incremental", n_steps=2, **kw).build())
    catch(ValueError, lambda: pkg.ReconstructionPlan(
        geometry=geom, **kw).build_incremental())
    catch(ValueError, lambda: pkg.ReconstructionPlan(
        geometry=geom, schedule="incremental", n_steps=2,
        **kw).build_batched(2))
    return out


def test_guards_raise_the_reference_messages():
    got, want = guard_messages(tplan), guard_messages(jplan)
    assert got == want
    assert "[(8, 16)]" in got[7]


def test_poll_folds_what_the_writer_commits(tmp_path):
    """The discovery loop: the scanner appends, poll folds, finalize
    stores to the sink — the fused volume, read back bit for bit."""
    proj = projections()
    w = StreamingProjectionWriter(str(tmp_path / "p"), proj.shape)
    sink = VolumeSink(str(tmp_path / "v"))
    sess = tplan.ReconstructionPlan(
        geometry=G, schedule="incremental", n_steps=4,
        device="cpu").build_incremental(
            source=ProjectionSource(str(tmp_path / "p")), sink=sink)
    assert sess.poll() == 0
    w.append(proj[:8], 0)
    assert sess.poll() == 1 and sess.pending_ranges() == [(8, 16)]
    w.append(proj[8:12], 8)
    w.append(proj[12:], 12)
    assert sess.poll() == 2 and sess.is_complete
    vol = sess.finalize()
    np.testing.assert_array_equal(vol.numpy(), fused())
    assert torch.equal(sink.read(), vol)


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tplan.ReconstructionPlan(geometry=G, schedule="incremental",
                                 n_steps=4).build_incremental()
