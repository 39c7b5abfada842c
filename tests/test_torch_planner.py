"""Port parity for the auto-planner (`repro_torch.planner`) against
`repro.planner`: the plan-aware cost model, the memory footprint, the
ranked grid search and `plan_from_spec(g, "auto")` give the same specs,
floats, feasibility and reasons on the same geometry — except where the
kernels' feasibility rules differ (a named case below). Plus the port's
measured refinement on the CPU."""
import dataclasses

import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import plan as jplan
from repro.core.distributed import IFDKGrid as JGrid
from repro import planner as jpl
from repro_torch.core import geometry as tgeo
from repro_torch.core import plan as tplan
from repro_torch.core.distributed import IFDKGrid as TGrid
from repro_torch.kernels.backproject import tune as ttune
from repro_torch import planner as tpl
from repro_torch.planner import measure as tmeasure
from repro_torch.planner import search as tsearch

torch.set_num_threads(1)

REL = 1e-12
FIELDS = ("t_load", "t_flt", "t_allgather", "t_h2d", "t_bp", "t_d2h",
          "t_reduce", "t_store", "overlap", "t_runtime")
# The reference's Pallas VMEM check passes for every kernel point here
# (a 512 x 512 detector: one projection is 1 MiB of f32 in its 8 MiB).
G_KERNEL = jgeo.paper_geometry(1024, 1024, 512)
# The paper's problem: a 2048 x 2048 detector, 16 MiB per f32 projection.
G_PAPER = jgeo.paper_geometry()


def _tg(g):
    return tgeo.CBCTGeometry(**dataclasses.asdict(g))


def _close(a, b):
    if isinstance(a, bool) or isinstance(b, bool):
        return a == b
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same_breakdown(got, want):
    return all(_close(getattr(got, f), getattr(want, f)) for f in FIELDS)


def _points(g, rc, impls, **kw):
    jp = list(jpl.enumerate_points(g, JGrid(*rc), impls=impls, **kw))
    tp = list(tpl.enumerate_points(_tg(g), TGrid(*rc), impls=impls, **kw))
    assert [p.spec() for p in tp] == [p.spec() for p in jp]
    return jp, tp


@pytest.mark.parametrize("impl", ["reference", "factorized", "kernel"])
@pytest.mark.parametrize("rc,data_size", [((1, 1), None), ((32, 8), None),
                                          ((8, 32), 8)])
def test_predict_point_and_footprint_match(impl, rc, data_size):
    jps, tps = _points(G_KERNEL, rc, (impl,), data_size=data_size)
    g = _tg(G_KERNEL)
    for jp, tp in zip(jps, tps):
        assert _same_breakdown(tpl.predict_point(g, tp),
                               jpl.predict_point(G_KERNEL, jp))
        assert dataclasses.asdict(tpl.plan_footprint(g, tp)) == \
            dataclasses.asdict(jpl.plan_footprint(G_KERNEL, jp))


def test_incremental_tail_matches():
    from repro.planner.cost import time_from_last_delta as jtail
    from repro_torch.planner.cost import time_from_last_delta as ttail
    jps, tps = _points(G_KERNEL, (8, 32), ("factorized", "kernel"),
                       schedules=("incremental",), data_size=8)
    assert jps
    for jp, tp in zip(jps, tps):
        assert _close(ttail(_tg(G_KERNEL), tp), jtail(G_KERNEL, jp))


@pytest.mark.parametrize("impls", [("reference", "factorized"),
                                   ("factorized", "kernel")])
def test_search_grids_matches_at_256_devices(impls):
    """Same ranked table: specs, predictions, feasibility and reasons, for
    every grid of 256 ranks (kernel points where the reference's VMEM
    check passes, so both rules admit them)."""
    kw = dict(n_devices=256, include_infeasible=True, top_k=None,
              impls=impls, precisions=("fp32", "bf16", "fp8_e4m3"),
              hbm_bytes=2**30)
    want = jpl.search_grids(G_KERNEL, **kw)
    got = tpl.search_grids(_tg(G_KERNEL), **kw)
    assert len(got) == len(want) > 100
    assert any(not p.feasible for p in want)
    for a, b in zip(got, want):
        assert a.spec() == b.spec()
        assert (a.point.grid.r, a.point.grid.c) == (b.point.grid.r,
                                                    b.point.grid.c)
        assert _same_breakdown(a.breakdown, b.breakdown)
        assert (a.feasible, a.reason) == (b.feasible, b.reason)
        assert a.plan is None


def test_kernel_feasibility_rules_differ_on_a_wide_detector():
    """The named case where the two kernel rules differ: at the paper's
    2048 x 2048 detector one f32 projection (16 MiB) overflows the Pallas
    kernel's 8 MiB VMEM at any block, so the reference prunes impl=
    'kernel'; the Hopper kernel gathers every projection from global
    memory at a staging budget of 0, so its floor is a tile's static
    tables (2,688 bytes) and the port admits it. Both prune a budget
    below that floor. (An HBM budget that fits every point isolates the
    kernel rule.)"""
    hbm = 2**40
    jp = jpl.PlanPoint(grid=JGrid(32, 8), schedule="fused", impl="kernel")
    tp = tpl.PlanPoint(grid=TGrid(32, 8), schedule="fused", impl="kernel")
    ok, reason = jpl.check_feasible(G_PAPER, jp, hbm)
    assert not ok and "fits VMEM" in reason
    assert tpl.check_feasible(_tg(G_PAPER), tp, hbm) == (True, "")
    ok, reason = tpl.check_feasible(_tg(G_PAPER), tp, hbm, vmem_budget=1024)
    assert not ok and "fits shared memory" in reason
    assert not jpl.check_feasible(G_PAPER, jp, hbm, vmem_budget=1024)[0]
    # the non-kernel impls are untouched by either budget
    for pl, grid, g in ((jpl, JGrid, G_PAPER), (tpl, TGrid, _tg(G_PAPER))):
        assert pl.check_feasible(g, pl.PlanPoint(grid=grid(32, 8)), hbm,
                                 vmem_budget=1024) == (True, "")


SPECS = ["auto", "auto,precision=fp16", "auto,n_steps=4",
         "auto,schedule=chunked", "auto,reduce=psum,impl=reference",
         "auto,y_chunks=4", "auto,schedule=incremental,n_steps=8"]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_from_spec_auto_picks_the_reference_plan(spec):
    g = jgeo.default_geometry(16, n_proj=32)
    want = jplan.plan_from_spec(g, spec)
    got = tplan.plan_from_spec(_tg(g), spec, device="cpu")
    fields = ("impl", "precision", "schedule", "n_steps", "y_chunks",
              "reduce", "window")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.device == "cpu" and got.mesh is None


def test_auto_plan_without_calibration_matches():
    g = jgeo.default_geometry(32, n_proj=64)
    for pins in ({}, {"precision": "bf16"}, {"schedule": "pipelined"}):
        want = jpl.auto_plan(g, calibration=None, **pins)
        got = tpl.auto_plan(_tg(g), calibration=None, device="cpu", **pins)
        assert (got.schedule, got.n_steps, got.precision, got.impl) == \
            (want.schedule, want.n_steps, want.precision, want.impl)


def test_auto_plan_errors_match():
    g = jgeo.default_geometry(16, n_proj=8)
    for pins, match in (({"blocks": (8, 8, 64)}, "cannot pin"),
                        ({"schedule": "fused", "n_steps": 2},
                         "pins conflict")):
        with pytest.raises(ValueError, match=match):
            jpl.auto_plan(g, **pins)
        with pytest.raises(ValueError, match=match):
            tpl.auto_plan(_tg(g), device="cpu", **pins)
    with pytest.raises(ValueError, match="exceed the memory budget"):
        tpl.auto_plan(_tg(g), device="cpu", hbm_bytes=1024)


def test_admitted_impls_follow_the_device(monkeypatch):
    assert tpl.admitted_impls(None, "cpu") == ("factorized",)
    monkeypatch.setattr(tsearch, "resolve_device", torch.device)
    assert tpl.admitted_impls(None, "cuda") == ("factorized", "kernel")
    g = _tg(jgeo.default_geometry(16, n_proj=8))
    plans = tpl.search_plans(g, None, device="cpu", impls=("kernel",),
                             top_k=None)
    assert plans and all(p.plan.impl == "kernel" and p.plan.device == "cpu"
                         for p in plans)


@pytest.mark.parametrize("call", [
    lambda: tpl.admitted_impls(),
    lambda: ttune.default_budget()])
def test_bare_defaults_name_the_card(call):
    """Both answer for the card by default, like every entry point of the
    port: on a host without one the bare call raises and names the way
    out (neither answers as if on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


class TestMeasure:
    def test_refine_times_and_reranks(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "pc.json"))
        tmeasure.clear_cache()
        g = _tg(jgeo.default_geometry(16, n_proj=8))
        props = tpl.search_plans(g, None, device="cpu", top_k=3,
                                 precisions=("fp32",))
        out = tpl.refine(g, props, top_k=2, iters=1)
        assert [p.measured is not None for p in out] == [True, True, False]
        assert out[0].measured <= out[1].measured
        hits = tmeasure.file_cache_hits()
        tmeasure.clear_cache()
        again = tpl.measure_proposal(g, out[0], iters=1)
        assert again == out[0].measured
        assert tmeasure.file_cache_hits() == hits + 1

    def test_cache_key_sees_engine_identity(self):
        g = _tg(jgeo.default_geometry(16, n_proj=8))
        props = tpl.search_plans(g, None, device="cpu", top_k=None,
                                 precisions=("fp32",), impls=("kernel",))
        keys = {tmeasure._measure_key(g, p, 1) for p in props}
        assert len(keys) == len(props)
        key = tmeasure._measure_key(g, props[0], 1)
        assert key[-4:-1] == ("cpu", "cpu", 1)
        assert '"blocks"' in key[6]

    def test_grid_only_proposal_is_not_measurable(self):
        g = _tg(jgeo.paper_geometry())
        (p,) = tpl.search_grids(g, 256, top_k=1)
        with pytest.raises(ValueError, match="grid-only"):
            tpl.measure_proposal(g, p)
