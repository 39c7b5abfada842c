"""Port parity for the batched engine: `ReconstructionPlan.build_batched`
of `repro_torch.core.plan` against the port's own `build()` and against
`repro.core.plan`'s `build_batched`.

The contract is the reference's: lane b of the batched engine is
BIT-equal to `build()(proj[b])`, for every impl, codec and schedule,
whether the lanes come stacked or as a list of tensors, and a junk or NaN
lane does not perturb the real lanes. Every batch size runs the plan's
one stage composition. Against the JAX
package's batched engine the lanes agree within 1e-5 of the max. The
filter sees each lane in the batches `build()` filters a scan in (per
micro-batch, restarting at the lane): checked on a scan whose N_p is not a
multiple of the filter batch (32), by the batch sizes the filter sees.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro_torch.core import filtering as tfilt
from repro_torch.core import plan as tplan
from repro_torch.core.geometry import CBCTGeometry

torch.set_num_threads(1)

JG = jgeo.default_geometry(16, n_proj=8)
G = CBCTGeometry(**dataclasses.asdict(JG))
REL = 1e-5
IMPLS = ("reference", "factorized", "kernel")
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")


@functools.lru_cache(maxsize=None)
def scans(geom=JG, seed=7):
    """The phantom's scan, a scaled copy and a noise scan, as numpy."""
    base = np.asarray(jph.forward_project(geom))
    rng = np.random.default_rng(seed)
    return np.stack([base, base * 1.5,
                     rng.standard_normal(base.shape).astype(np.float32)])


def plan(geom=G, **kw):
    return tplan.ReconstructionPlan(geometry=geom, device="cpu", **kw)


def assert_lanes_bit_equal(p, batch):
    """Lane b of the stacked batch and of the same lanes as a list of
    tensors is bit-equal to build() of lane b."""
    engine = p.build_batched(batch.shape[0])
    out = engine(batch)
    listed = engine([torch.as_tensor(lane) for lane in batch])
    single = p.build()
    assert out.shape == listed.shape == ((batch.shape[0],)
                                         + p.geometry.volume_shape())
    for b in range(batch.shape[0]):
        want = single(batch[b])
        assert torch.equal(out[b], want), f"lane {b}"
        assert torch.equal(listed[b], want), f"listed lane {b}"
    return out


def test_a_list_of_lane_tensors_is_the_stacked_batch():
    """build_batched(3) fed its lanes as a list of tensors gives the
    stacked batch's volumes, bit for bit, and build()'s of each lane."""
    p = plan(impl="kernel", precision="fp16")
    batch = scans()
    lanes = [torch.as_tensor(lane) for lane in batch]
    engine = p.build_batched(3)
    got = engine(lanes)
    assert torch.equal(got, engine(batch))
    for lane, vol in zip(lanes, got):
        assert torch.equal(vol, p.build()(lane))
    with pytest.raises(ValueError, match=r"got 2 lanes"):
        engine(lanes[:2])
    with pytest.raises(ValueError, match=r"projections must be \(B, \)"):
        engine(lanes[:2] + [lanes[2][:4]])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("impl", IMPLS)
def test_lanes_bit_equal_to_build(impl, codec):
    assert_lanes_bit_equal(plan(impl=impl, precision=codec), scans())


@pytest.mark.parametrize("schedule,kw", [
    ("pipelined", {"n_steps": 2}), ("chunked", {"n_steps": 2,
                                                "y_chunks": 2})])
def test_lanes_bit_equal_under_every_schedule(schedule, kw):
    assert_lanes_bit_equal(plan(schedule=schedule, precision="fp8_e4m3",
                                **kw), scans())


@pytest.mark.parametrize("impl,codec", [("factorized", "fp32"),
                                        ("kernel", "fp32"),
                                        ("kernel", "fp8_e4m3")])
def test_lanes_match_jax_build_batched(impl, codec):
    got = plan(impl=impl, precision=codec).build_batched(3)(scans()).numpy()
    want = np.asarray(jplan.ReconstructionPlan(
        geometry=JG, impl=impl, precision=codec).build_batched(3)(scans()))
    for b in range(3):
        err = np.max(np.abs(got[b] - want[b])) / np.max(np.abs(want[b]))
        assert err < REL, f"lane {b}: {err:.3e}"


def test_a_junk_lane_cannot_perturb_the_real_ones():
    real = scans()
    batched = plan().build_batched(4)
    outs = [batched(np.concatenate([real, pad[None]]))
            for pad in (np.zeros_like(real[0]), np.full_like(real[0], 1e30),
                        np.full_like(real[0], np.nan))]
    for other in outs[1:]:
        assert torch.equal(outs[0][:3], other[:3])
    assert torch.isfinite(outs[2][:3]).all()
    assert torch.isnan(outs[2][3]).all()


@pytest.mark.parametrize("schedule,kw,per_scan", [
    ("fused", {}, [32, 8]), ("pipelined", {"n_steps": 2}, [20, 20]),
    ("chunked", {"n_steps": 4, "y_chunks": 2}, [10, 10, 10, 10])])
def test_filter_sees_the_batches_build_sees(monkeypatch, schedule, kw,
                                            per_scan):
    """N_p = 40 is not a multiple of the filter's 32-projection batch:
    each lane is filtered in the batches build() filters a scan in (per
    micro-batch, never a batch straddling two lanes), and the lanes are
    bit-equal."""
    jg = jgeo.default_geometry(8, n_proj=40)
    g = CBCTGeometry(**dataclasses.asdict(jg))
    seen = []
    real = tfilt._filter_batch

    def spy(proj, *args, **kwargs):
        seen.append(proj.shape[0])
        return real(proj, *args, **kwargs)

    monkeypatch.setattr(tfilt, "_filter_batch", spy)
    p = plan(geom=g, precision="fp16", schedule=schedule, **kw)
    p.build()(scans(jg)[0])
    assert seen == per_scan
    seen.clear()
    p.build_batched(2)(scans(jg)[:2])
    assert seen == per_scan * 2
    assert_lanes_bit_equal(p, scans(jg)[:2])


def test_engine_contract():
    """One cache entry a plan: its first engine of any batch size makes
    the stage composition, and build() and every other size reuse it."""
    tplan.clear_engine_cache()
    before = tplan.engine_cache_stats()
    p = plan()
    a = p.build_batched(2)
    assert p.build_batched(4) is not a and p.build() is not a
    assert p.build() is p.build()
    stats = tplan.engine_cache_stats()
    assert stats["size"] == 1
    assert stats["misses"] - before["misses"] == 1
    assert stats["hits"] - before["hits"] == 4
    with pytest.raises(ValueError, match="must be >= 1"):
        p.build_batched(0)
    with pytest.raises(ValueError, match=r"projections must be \(B, \)"):
        a(scans())
    with pytest.raises(ValueError, match="incremental"):
        plan(schedule="incremental", n_steps=2).build_batched(2)
    assert a.collectives is None
