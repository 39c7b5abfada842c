"""Port parity for the traced engines: `ReconstructionPlan.build_traced`
and `TracedIncrementalSession` of `repro_torch.core.plan` against
`repro.core.plan`'s, on the CPU, at the tolerance of the other plan tests
(1e-5 of the max). Plus: the spans are the `obs.attribution.STAGE_FIELDS`
vocabulary, the `_Stages` split leaves build() as it was, and the
`blocks`/`vmem_budget` spec keys parse in both packages.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro.obs import trace as jtrace
from repro_torch import io as tio
from repro_torch.core import geometry as tgeo
from repro_torch.core import plan as tplan
from repro_torch.obs import trace as ttrace
from repro_torch.obs.attribution import STAGE_FIELDS

torch.set_num_threads(1)

REL = 1e-5
JG = jgeo.CBCTGeometry(
    n_proj=12, n_u=14, n_v=10, d_u=4.8 / 14, d_v=4.8 / 14, d=4.0, dsd=8.0,
    n_x=8, n_y=8, n_z=8, d_x=0.25, d_y=0.25, d_z=0.25)
G = tgeo.CBCTGeometry(**dataclasses.asdict(JG))
SCHEDULES = {"fused": {}, "pipelined": {"n_steps": 2},
             "chunked": {"n_steps": 2, "y_chunks": 2}}


@functools.lru_cache(maxsize=None)
def projections():
    return np.array(jph.forward_project(JG))


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# every impl x codec fused; the batch schedules (which trace as fused)
# for the two deployment impls
TRACED_CASES = (
    [(impl, codec, "fused") for impl in ("reference", "factorized", "kernel")
     for codec in ("fp32", "bf16", "fp8_e4m3")]
    + [(impl, "fp32", schedule) for impl in ("factorized", "kernel")
       for schedule in ("pipelined", "chunked")])


@pytest.mark.parametrize("impl,codec,schedule", TRACED_CASES)
def test_build_traced_matches_reference(impl, codec, schedule):
    kw = dict(impl=impl, precision=codec, schedule=schedule,
              **SCHEDULES[schedule])
    want = jplan.ReconstructionPlan(geometry=JG, **kw).build_traced()(
        projections())
    plan = tplan.ReconstructionPlan(geometry=G, device="cpu", **kw)
    got = plan.build_traced()(projections())
    assert got.dtype == torch.float32 and tuple(got.shape) == G.volume_shape()
    assert _rel(got, want) < REL
    # the traced decomposition is the fused engine's: for a fused plan
    # the same operations in the same order as build()
    if schedule == "fused":
        assert torch.equal(got, plan.build()(projections()))


def _spans(pkg_trace, run):
    tracer = pkg_trace.Tracer(enabled=True)
    prev = pkg_trace.set_tracer(tracer)
    try:
        run()
    finally:
        pkg_trace.set_tracer(prev)
    return tracer


def test_stage_spans_are_the_attribution_vocabulary(tmp_path):
    """A source -> traced engine -> sink run emits one span per entry of
    STAGE_FIELDS, fenced, inside engine.traced; the reference's run emits
    the same names."""
    proj = projections()
    src = tio.ProjectionSource.write(str(tmp_path / "p"), proj)
    sink = tio.VolumeSink(str(tmp_path / "v"))
    plan = tplan.ReconstructionPlan(geometry=G, device="cpu")
    out = {}
    tracer = _spans(ttrace, lambda: out.setdefault(
        "vol", plan.build_traced(source=src, sink=sink)()))
    names = [e["name"] for e in tracer.spans("stage.")]
    assert sorted(names) == sorted(STAGE_FIELDS)
    (engine,) = tracer.spans("engine.traced")
    assert engine["args"]["schedule"] == "fused"
    assert torch.equal(sink.read(), out["vol"])
    jt = _spans(jtrace, lambda: jplan.ReconstructionPlan(
        geometry=JG).build_traced()(proj))
    assert {e["name"] for e in jt.spans("stage.")} == \
        set(STAGE_FIELDS) - {"stage.read", "stage.write"}
    with pytest.raises(TypeError, match="no ProjectionSource"):
        plan.build_traced()()


def test_stages_split_leaves_build_unchanged():
    """gather_batch is the composition of the two halves the traced
    engines time apart; build() reconstructs the reference's volume as
    before (test_torch_plan_*.py hold every codec x schedule to it)."""
    plan = tplan.ReconstructionPlan(geometry=G, device="cpu",
                                    precision="fp8_e4m3")
    st = plan._make_stages()
    raw = torch.as_tensor(projections())
    pm = torch.as_tensor(tgeo.projection_matrices(G))
    a = st.gather_batch(pm, raw)()
    b = st.gather_cols(pm, st.filter_encode(raw))()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = jplan.ReconstructionPlan(geometry=JG, precision="fp8_e4m3").build()(
        projections())
    assert _rel(plan.build()(projections()), want) < REL


DELTAS = [(0, 3), (3, 6), (6, 9), (9, 12)]


def _traced_session(pkg, **kw):
    geom = G if pkg is tplan else JG
    if pkg is tplan:
        kw["device"] = "cpu"
    return pkg.ReconstructionPlan(geometry=geom, schedule="incremental",
                                  n_steps=4, **kw).build_traced()


@pytest.mark.parametrize("impl", ["factorized", "kernel"])
@pytest.mark.parametrize("codec", ["fp32", "fp8_e4m3"])
def test_traced_session_matches_reference(impl, codec):
    proj = projections()
    sessions = [_traced_session(pkg, impl=impl, precision=codec)
                for pkg in (jplan, tplan)]
    for j, (lo, hi) in enumerate(DELTAS):
        final = j == len(DELTAS) - 1
        out = [s.update(proj[lo:hi], (lo, hi), finalize=final)
               for s in sessions]
    want, got = out
    assert isinstance(sessions[1], tplan.TracedIncrementalSession)
    assert _rel(got, want) < REL
    assert torch.equal(got, sessions[1].finalize())
    secs = sessions[1].stage_seconds()
    assert set(secs) == set(sessions[0].stage_seconds()) == {
        "stage.filter", "stage.allgather", "stage.backproject",
        "stage.reduce"}
    assert all(v > 0 for v in secs.values())
    # the untraced session folds the same deltas to the same volume
    plain = tplan.ReconstructionPlan(
        geometry=G, device="cpu", impl=impl, precision=codec,
        schedule="incremental", n_steps=4).build_incremental()
    for lo, hi in DELTAS:
        plain.update(proj[lo:hi], (lo, hi))
    assert torch.equal(plain.finalize(), got)


def test_traced_session_spans_and_staged_deltas():
    proj = projections()
    sess = _traced_session(tplan)

    def run():
        staged = sess.stage(proj[:6], (0, 6))
        sess.update(staged)
        sess.update(proj[6:], (6, 12))
        sess.finalize(partial=True)
    tracer = _spans(ttrace, run)
    names = [e["name"] for e in tracer.spans("stage.")]
    assert names.count("stage.filter") == names.count("stage.allgather") == 2
    assert names.count("stage.backproject") == 2
    assert names.count("stage.reduce") == 1
    assert set(names) <= set(STAGE_FIELDS)
    with pytest.raises(TypeError, match="angle_slice is required"):
        sess.update(proj[:6])


@pytest.mark.parametrize("spec,fields", [
    ("impl=kernel,blocks=8:8:32,vmem_budget=65536",
     {"impl": "kernel", "blocks": (8, 8, 32), "vmem_budget": 65536}),
    ("schedule=pipelined,n_steps=2,vmem_budget=1024",
     {"schedule": "pipelined", "n_steps": 2, "vmem_budget": 1024}),
])
def test_launch_spec_keys_parse_in_both_packages(spec, fields):
    want = jplan.plan_from_spec(JG, spec)
    got = tplan.plan_from_spec(G, spec, device="cpu")
    for key, val in fields.items():
        assert getattr(want, key) == getattr(got, key) == val
    with pytest.raises(ValueError, match="did you mean 'blocks=...'"):
        tplan.plan_from_spec(G, "blocs=8:8:64")
