"""Port parity for the whole slice: `repro_torch.core.plan` (and fdk,
cache, distributed) against `repro`.

Both packages build their plan from the same plain fields
(`plan_from_reference` on the port's side) and reconstruct the same numpy
projections on the CPU, for every impl x codec x {fused, pipelined,
chunked}; the volumes agree to 1e-5 of the max (f32 in both; the encoded
streams are bit-equal, see test_torch_precision.py). That matrix runs one
impl per file, test_torch_plan_<impl>.py, through `check_slice` below, so
that its JAX compiles spread over the test workers. Here: the phantom
bound, validate() errors, the device default, the batched, incremental
and I/O engines being there, and what the port still leaves out.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import distributed as jdist
from repro.core import fdk as jfdk
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro_torch import io as tio
from repro_torch.core import cache as tcache
from repro_torch.core import distributed as tdist
from repro_torch.core import fdk as tfdk
from repro_torch.core import geometry as tgeo
from repro_torch.core import phantom as tph
from repro_torch.core import plan as tplan
from repro_torch.kernels.backproject import kernel as tbpk

# Tiny shapes gain nothing from intra-op threads, and the suite runs several
# test workers on one host: one thread each keeps them from contending.
torch.set_num_threads(1)

REL = 1e-5
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
SCHEDULES = {"fused": {}, "pipelined": {"n_steps": 2},
             "chunked": {"n_steps": 2, "y_chunks": 2}}
# Non-square detector; 12 projections split into 2 micro-batches.
G = jgeo.CBCTGeometry(
    n_proj=12, n_u=14, n_v=10, d_u=4.8 / 14, d_v=4.8 / 14, d=4.0, dsd=8.0,
    n_x=8, n_y=8, n_z=8, d_x=0.25, d_y=0.25, d_z=0.25)


@functools.lru_cache(maxsize=None)
def projections():
    return np.array(jph.forward_project(G))


def check_slice(impl, codec, schedule):
    """One plan point through both packages, from the same plain fields."""
    jp = jplan.ReconstructionPlan(geometry=G, impl=impl, precision=codec,
                                  schedule=schedule, **SCHEDULES[schedule])
    want = np.asarray(jp.build()(projections()))
    tp = tplan.plan_from_reference(dataclasses.asdict(jp), device="cpu")
    assert (tp.impl, tp.schedule, tp.n_steps, tp.y_chunks) == \
        (impl, schedule, jp.n_steps, jp.y_chunks)
    got = tp.build()(projections())
    assert got.dtype == torch.float32 and tuple(got.shape) == G.volume_shape()
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err < REL, f"{impl}/{codec}/{schedule}: {err:.3e}"


@pytest.mark.parametrize("impl", ["factorized", "kernel"])
def test_phantom_recovery_24(impl):
    """Interior RMSE < 0.17 at 24^3/36 views, the reference suite's bound
    (tests/test_fdk_end_to_end.py), on the port's own phantom and
    projections."""
    g = tgeo.default_geometry(24, n_proj=36)
    vol = tfdk.reconstruct(g, tph.forward_project(g, device="cpu"),
                           impl=impl, device="cpu")
    ph = tph.shepp_logan_volume(g, device="cpu")
    m = g.n_x // 5
    it = (slice(m, g.n_x - m),) * 3
    rmse = float(((vol[it] - ph[it]) ** 2).mean().sqrt())
    assert rmse < 0.17


def test_plan_from_geometry_dict_and_plan_fields():
    tp = tplan.plan_from_reference(dataclasses.asdict(G), device="cpu")
    assert dataclasses.asdict(tp.geometry) == dataclasses.asdict(G)
    assert (tp.impl, tp.window, tp.precision, tp.schedule) == \
        ("factorized", "ramlak", "fp32", "fused")
    jp = jplan.ReconstructionPlan(geometry=G, precision=None,
                                  window="hann")
    tp = tplan.plan_from_reference(
        {"geometry": G, "impl": "kernel", "window": "hann",
         "precision": {"storage": "fp8"}}, device="cpu")
    assert tp.resolved_precision().storage == "fp8_e4m3"
    assert tp.window == jp.window
    # precision None resolves per device, as the reference resolves per backend
    tp = tplan.plan_from_reference(dataclasses.asdict(jp), device="cpu")
    assert tp.resolved_precision().storage == \
        jp.resolved_precision().storage == "bf16"


def test_plan_from_reference_rejects_what_is_not_ported():
    """A pinned Pallas block or VMEM budget does not carry over to the
    card's kernel (its launch shape is a Hopper tile and a shared-memory
    budget, test_torch_tune.py): ValueError, naming why."""
    fields = dataclasses.asdict(
        jplan.ReconstructionPlan(geometry=G, impl="kernel", blocks=(4, 4, 4)))
    with pytest.raises(ValueError, match="does not carry over to the card"):
        tplan.plan_from_reference(fields, device="cpu")
    fields = dict(fields, blocks=None, vmem_budget=1 << 20)
    with pytest.raises(ValueError, match="does not carry over to the card"):
        tplan.plan_from_reference(fields, device="cpu")
    with pytest.raises(ValueError, match="is not the port's mesh"):
        tplan.plan_from_reference(
            {"geometry": G, "mesh": object()}, device="cpu")
    with pytest.raises(ValueError, match="unknown reference plan fields"):
        tplan.plan_from_reference({"geometry": G, "blox": 1}, device="cpu")
    with pytest.raises(ValueError, match="geometry fields"):
        tplan.plan_from_reference({"n_proj": 4}, device="cpu")


BAD_PLANS = [
    ({"impl": "pallas"}, "unknown back-projection impl"),
    ({"window": "blackman"}, "unknown window"),
    ({"schedule": "eager"}, "unknown schedule"),
    ({"reduce": "allreduce"}, "unknown reduce mode"),
    ({"precision": "int4"}, "unknown storage precision"),
    ({"n_steps": 0, "schedule": "pipelined"}, "must be >= 1"),
    ({"n_steps": 2}, "the fused schedule has no micro-batching"),
    ({"n_steps": 5, "schedule": "pipelined"}, "must divide into n_steps"),
    ({"schedule": "chunked", "n_steps": 2}, "requires y_chunks"),
    ({"schedule": "chunked", "n_steps": 2, "y_chunks": 3},
     "must divide into y_chunks"),
    ({"y_chunks": 2}, "y_chunks only applies"),
    ({"reduce": "scatter"}, "needs a mesh with a 'data' axis"),
]


@pytest.mark.parametrize("kwargs,msg", BAD_PLANS,
                         ids=[m for _, m in BAD_PLANS])
def test_validate_errors_match_reference(kwargs, msg):
    with pytest.raises(ValueError, match=msg):
        jplan.ReconstructionPlan(geometry=G, **kwargs).validate()
    with pytest.raises(ValueError, match=msg):
        tplan.ReconstructionPlan(geometry=tgeo.CBCTGeometry(
            **dataclasses.asdict(G)), device="cpu", **kwargs).validate()


def test_kernel_impl_needs_even_nz():
    g = tgeo.CBCTGeometry(**dict(dataclasses.asdict(G), n_z=7))
    with pytest.raises(ValueError, match="requires even N_z"):
        tplan.ReconstructionPlan(geometry=g, impl="kernel",
                                 device="cpu").validate()


def test_plan_defaults_to_the_card():
    """Without device="cpu" the plan asks for CUDA; on a host without a
    card it raises and names the way out."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    g = tgeo.default_geometry(8)
    assert tplan.ReconstructionPlan.__dataclass_fields__["device"].default \
        == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tplan.ReconstructionPlan(geometry=g)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfdk.reconstruct(g, np.zeros(g.proj_shape(), np.float32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tplan.plan_from_reference(dataclasses.asdict(G))


def test_the_stateful_and_batched_engines_build(tmp_path):
    """build_batched, build_incremental (from a plan carried across by
    plan_from_reference or plan_from_spec with schedule="incremental") and
    build(source=, sink=) give engines; build() of an incremental plan
    points at build_incremental, as the reference does."""
    g = tgeo.CBCTGeometry(**dataclasses.asdict(G))
    plan = tplan.ReconstructionPlan(geometry=g, device="cpu")
    fn = plan.build()
    proj = projections()
    assert torch.equal(plan.build_batched(2)(np.stack([proj, proj]))[1],
                       fn(proj))
    jp = jplan.ReconstructionPlan(geometry=G, schedule="incremental",
                                  n_steps=2)
    for tp in (tplan.plan_from_reference(dataclasses.asdict(jp),
                                         device="cpu"),
               tplan.plan_from_spec(g, "schedule=incremental,n_steps=2",
                                    device="cpu")):
        sess = tp.build_incremental()
        assert isinstance(sess, tplan.IncrementalSession)
        sess.update(proj[:6], (0, 6)).update(proj[6:], (6, 12))
        assert torch.equal(sess.finalize(), fn(proj))
        with pytest.raises(ValueError, match="build_incremental"):
            tp.build()
    src = tio.ProjectionSource.write(str(tmp_path / "p"), proj)
    sink = tio.VolumeSink(str(tmp_path / "v"))
    vol = plan.build(source=src, sink=sink)()
    assert torch.equal(vol, fn(proj)) and torch.equal(sink.read(), vol)
    with pytest.raises(TypeError, match="without a ProjectionSource"):
        plan.build(sink=sink)()


def test_what_this_slice_leaves_out_raises():
    """Nothing of the plan API raises NotImplementedError any more: the
    traced engine, the planner's "auto" token and the launch-shape keys
    are ported; a tile the kernel does not compile is a ValueError."""
    g = tgeo.CBCTGeometry(**dataclasses.asdict(G))
    plan = tplan.ReconstructionPlan(geometry=g, device="cpu")
    assert plan.build_traced()(projections()).shape == g.volume_shape()
    assert isinstance(tplan.plan_from_spec(g, "auto", device="cpu"),
                      tplan.ReconstructionPlan)
    assert tplan.plan_from_spec(g, "impl=kernel,blocks=8:8:32",
                                device="cpu").blocks == (8, 8, 32)
    with pytest.raises(ValueError, match="not a compiled tile"):
        tplan.plan_from_spec(g, "impl=kernel,blocks=4:4:4",
                             device="cpu").validate()


def test_plan_from_spec_describe_and_engine_cache():
    g = tgeo.CBCTGeometry(**dataclasses.asdict(G))
    plan = tplan.plan_from_spec(
        g, "schedule=chunked, n_steps=2, y_chunks=2, precision=half",
        device="cpu", impl="kernel")
    launch = plan.resolved_launch()
    assert launch[0] in tbpk.TILES
    assert plan.describe() == {
        "schedule": "chunked", "impl": "kernel", "window": "ramlak",
        "precision": "fp16", "grid": (1, 1), "n_steps": 2, "y_chunks": 2,
        "reduce": "psum", "device": "cpu", "blocks": launch[0],
        "stage_bytes": launch[1]}
    with pytest.raises(ValueError, match="did you mean 'schedule=pipelined'"):
        tplan.plan_from_spec(g, "pipelned")
    with pytest.raises(ValueError, match="unknown plan spec key"):
        tplan.plan_from_spec(g, "stepz=2")
    tplan.clear_engine_cache()
    before = tplan.engine_cache_stats()["hits"]
    fn = plan.build()
    assert plan.build() is fn
    assert tplan.engine_cache_stats()["hits"] == before + 1
    with pytest.raises(ValueError, match=r"projections must be \(N_p"):
        fn(np.zeros((3, 4, 5), np.float32))


def test_fdk_helpers_match():
    tg = tgeo.CBCTGeometry(**dataclasses.asdict(G))
    assert tfdk.fdk_scale(tg) == jfdk.fdk_scale(G)
    assert tfdk.gups(tg, 0.25) == jfdk.gups(G, 0.25)
    with pytest.raises(ValueError, match="unknown back-projection impl"):
        tfdk._get_backprojector("mxu")


def test_slab_reparameterization_matches():
    pm = jgeo.projection_matrices(G)
    for i0 in (0.0, 3.0):
        np.testing.assert_array_equal(
            tdist.shift_pmats_i(torch.from_numpy(pm), i0).numpy(),
            np.asarray(jdist.shift_pmats_i(jnp.asarray(pm), jnp.float32(i0))))
        np.testing.assert_array_equal(
            tplan.shift_pmats_j(torch.from_numpy(pm), i0).numpy(),
            np.asarray(jplan.shift_pmats_j(jnp.asarray(pm), jnp.float32(i0))))
    assert tdist.IFDKGrid(2, 3).n_ranks == jdist.IFDKGrid(2, 3).n_ranks == 6


def test_counting_lru_matches_reference():
    """The same operation sequence gives the same contents and counters."""
    caches = [jcache.CountingLRU(capacity=2), tcache.CountingLRU(capacity=2)]
    for c in caches:
        c.put("a", 1)
        c.put("b", 2)
        c.get("a")
        c.put("c", 3)            # evicts "b"
        c.get("b")
        c.get(["unhashable"])
        c.put(["unhashable"], 0)
        assert c.get_or_build("d", lambda: 4) == 4
        assert c.get_or_build({}, lambda: 5) == 5
    (j, t) = caches
    assert t.stats() == j.stats()
    assert t.keys() == j.keys() == ["c", "d"]
    assert "c" in t and [] not in t and len(t) == 2
    t.clear(reset_counters=True)
    assert t.stats() == {"size": 0, "capacity": 2, "hits": 0, "misses": 0,
                         "evictions": 0, "unhashable": 0}
    off = tcache.CountingLRU(capacity=0)
    off.put("a", 1)
    assert off.get("a") is None and len(off) == 0
