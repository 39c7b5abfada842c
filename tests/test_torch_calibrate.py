"""Port parity for the trace-calibrated planner
(`repro_torch.planner.calibrate`) against `repro.planner.calibrate`: the
same samples fed to both stores fit equal `MachineCalibration.to_dict()`;
traced runs record the same predicted basis; the calibrated measured pick
is tested deterministically, with `measure_proposal` stubbed (the
reference's wall-clock version is one of its known failures)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import plan as jplan
from repro.filecache import JsonFileCache as JCache
from repro.planner import calibrate as jcal
from repro_torch.core import geometry as tgeo
from repro_torch.core import plan as tplan
from repro_torch.core.phantom import forward_project
from repro_torch.filecache import JsonFileCache as TCache
from repro_torch.planner import calibrate as tcal
from repro_torch.planner import measure as tmeasure
from repro_torch.planner import search as tsearch
from repro_torch.planner.cost import PlanPoint, predict_plan

torch.set_num_threads(1)

G = jgeo.default_geometry(16, n_proj=8)
TG = tgeo.CBCTGeometry(**dataclasses.asdict(G))
STAGES = ("stage.filter", "stage.allgather", "stage.backproject",
          "stage.reduce", "stage.read", "stage.write")


def _stores(tmp_path=None):
    """(reference, port) stores: in-memory, or file-backed on tmp_path."""
    if tmp_path is None:
        return jcal.CalibrationStore(), tcal.CalibrationStore()
    path = os.path.join(str(tmp_path), "store.json")
    return (jcal.CalibrationStore(JCache("REPRO_CALIB_CACHE", "c.json",
                                         path=path)),
            tcal.CalibrationStore(TCache("REPRO_CALIB_CACHE", "c.json",
                                         path=path)))


def _samples(kind, seed):
    """A reproducible sample set: (key kwargs, predicted, measured)."""
    rng = np.random.default_rng(seed)
    out = []
    if kind in ("bp", "mixed"):
        for impl, ratio in (("factorized", 2.5), ("kernel", 0.7),
                            ("reference", 40.0)):
            for _ in range(6):
                p = float(rng.uniform(1e-3, 1e-1))
                out.append((dict(stage="stage.backproject", impl=impl),
                            p, p * ratio * float(rng.lognormal(0, 0.05))))
    if kind in ("stages", "mixed"):
        for stage, ratio in zip(STAGES, (3.0, 0.5, 1.0, 7.0, 0.2, 11.0)):
            if stage == "stage.backproject":
                continue
            for _ in range(5):
                p = float(rng.uniform(1e-4, 1e-2))
                out.append((dict(stage=stage, impl="factorized"), p,
                            p * ratio * float(rng.lognormal(0, 0.1))))
    if kind == "outliers":
        for i in range(8):
            p = 1e-2 * (1 + i)
            m = p * (2.0 if i != 3 else 500.0)   # one wild sample
            out.append((dict(stage="stage.filter", impl="factorized"), p, m))
    return out


def _record(store, samples, **fixed):
    for kw, p, m in samples:
        key = dict(system="abci-v100", schedule="fused", reduce="psum",
                   precision="bf16", bucket=15)
        key.update(kw)
        key.update(fixed)
        store.record(predicted_s=p, measured_s=m, **key)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["bp", "stages", "mixed", "outliers"])
def test_same_samples_fit_equal_calibrations(kind, seed):
    js, ts = _stores()
    samples = _samples(kind, seed)
    _record(js, samples)
    _record(ts, samples)
    want, got = js.fit(), ts.fit()
    assert got.to_dict() == want.to_dict()
    assert not got.is_empty
    assert tcal.MachineCalibration.from_dict(got.to_dict()) == got
    assert got.summary() == want.summary()


def test_step_overhead_fit_matches():
    """Engine timings (planner/measure.py's deposits): fused vs stepped
    pairs fit the same per-step overhead in both packages."""
    from repro.planner.cost import PlanPoint as JPoint
    js, ts = _stores()
    for store, g, point, grid in (
            (js, G, JPoint, jplan.ReconstructionPlan(geometry=G).grid),
            (ts, TG, PlanPoint, tplan.ReconstructionPlan(
                geometry=TG, device="cpu").grid)):
        fused = point(grid=grid, precision="bf16")
        stepped = point(grid=grid, schedule="pipelined", n_steps=4,
                        precision="bf16")
        for i in range(tcal.MIN_SAMPLES):
            store.record_engine(g, fused, 0.010 + 1e-5 * i)
            store.record_engine(g, stepped, 0.012 + 3e-5 * i)
    want, got = js.fit(), ts.fit()
    assert got.to_dict() == want.to_dict()
    assert got.step_overhead_s == pytest.approx(5e-4, rel=0.1)


@pytest.mark.parametrize("samples", [[(1.0, 2.0)] * 2,
                                     [(1.0, 2.0), (2.0, 4.1), (3.0, 5.9)],
                                     [(0.0, 1.0), (1.0, 0.0), (1.0, 3.0)],
                                     [(1e-3, 1.0), (1.0, 1.0), (2.0, 2.0),
                                      (3.0, 3.1), (4.0, 3.9)]])
def test_robust_scale_matches(samples):
    assert tcal.robust_scale(samples) == jcal.robust_scale(samples)


@pytest.mark.parametrize("schedule,kw", [("fused", {}),
                                         ("pipelined", {"n_steps": 2}),
                                         ("incremental", {"n_steps": 2})])
def test_record_traced_run_matches(schedule, kw):
    seconds = {s: 1e-3 * (i + 1) for i, s in enumerate(STAGES)}
    js, ts = _stores()
    jp = jplan.ReconstructionPlan(geometry=G, schedule=schedule,
                                  precision="bf16", **kw)
    tp = tplan.ReconstructionPlan(geometry=TG, schedule=schedule,
                                  precision="bf16", device="cpu", **kw)
    js.record_traced_run(jp, seconds)
    ts.record_traced_run(tp, seconds)
    want = {k[1:]: v for k, v in js.samples().items()}
    got = {k[1:]: v for k, v in ts.samples().items()}
    # stage.reduce is predicted 0 on a 1 x 1 grid: no sample to fit
    assert got == want
    assert {k[1] for k in got} == set(STAGES) - {"stage.reduce"}


def test_port_and_reference_samples_share_a_file_apart(tmp_path):
    """One REPRO_CALIB_CACHE file for both packages: each store fits only
    its own package's samples (the port's keys carry their own tag)."""
    js, ts = _stores(tmp_path)
    _record(js, _samples("bp", 0))
    _record(ts, [(kw, p, 10 * m) for kw, p, m in _samples("bp", 0)])
    assert js.n_samples() == ts.n_samples() == 18
    assert ts.fit().bp_scales["factorized"] == pytest.approx(
        10 * js.fit().bp_scales["factorized"], rel=1e-9)
    tags = {json.loads(k)[0] for k in json.loads(
        (tmp_path / "store.json").read_text())["entries"]}
    assert tags == {"cal", "cal-torch"}


class TestDefaultStoreHooks:
    def test_default_calibration_none_when_disabled(self, monkeypatch):
        monkeypatch.setenv("REPRO_CALIB_CACHE", "off")
        prev = tcal.set_default_store(None)
        try:
            tcal.record_traced_run(
                tplan.ReconstructionPlan(geometry=TG, device="cpu"),
                {"stage.filter": 1.0})
            assert tcal.default_calibration() is None
            assert tcal.resolve_calibration("auto", tcal.ABCI) == \
                (None, tcal.ABCI)
        finally:
            tcal.set_default_store(prev)

    def test_traced_runs_feed_the_installed_store(self):
        """build_traced (tracer on) and the traced session deposit their
        stage seconds; MIN_SAMPLES runs fit the stage constants."""
        from repro_torch.obs.trace import Tracer, set_tracer
        store = tcal.CalibrationStore()
        prev = tcal.set_default_store(store)
        prev_tracer = set_tracer(Tracer(enabled=True))
        try:
            proj = forward_project(TG, device="cpu")
            plan = tplan.ReconstructionPlan(geometry=TG, device="cpu",
                                            precision="bf16")
            fn = plan.build_traced()
            for _ in range(tcal.MIN_SAMPLES):
                fn(proj)
            inc = dataclasses.replace(plan, schedule="incremental",
                                      n_steps=2)
            sess = inc.build_traced()
            sess.update(proj[:4], (0, 4))
            sess.update(proj[4:], (4, 8), finalize=True)
            sess.finalize()                      # records once
            cal = tcal.default_calibration()
        finally:
            set_tracer(prev_tracer)
            tcal.set_default_store(prev)
        keys = store.samples()
        inc_keys = {k[2]: v for k, v in keys.items() if k[4] == "incremental"}
        # stage.reduce is predicted 0 on a 1 x 1 grid: not recorded
        assert set(inc_keys) == {"stage.filter", "stage.allgather",
                                 "stage.backproject"}
        assert all(len(v) == 1 for v in inc_keys.values())
        assert cal is not None and "t_flt" in cal.stage_scales
        assert "factorized" in cal.bp_scales


class TestCalibratedAutoMeasured:
    """The calibrated-auto pick's measured time is no worse than the stock
    pick's: with measure_proposal stubbed by a deterministic cost, the
    refinement re-ranks by it and calibration only moves the pick toward
    what the store measured."""

    def test_calibrated_pick_not_slower(self, monkeypatch):
        # truth on this "host": the factorized back-projection runs 50x
        # slower than the stock model says; the stub "measures" a plan as
        # the model priced with that truth (a function of the plan alone)
        store = tcal.CalibrationStore()
        _record(store, [(dict(stage="stage.backproject", impl="factorized"),
                         1e-3 * (1 + i), 5e-2 * (1 + i)) for i in range(5)])
        cal = store.fit()

        def truth(g, proposal, iters=2):
            return predict_plan(proposal.plan, calibration=cal).t_runtime

        monkeypatch.setattr(tmeasure, "measure_proposal", truth)
        kw = dict(device="cpu", measure=True, top_k=4)
        stock = tsearch.auto_plan(TG, calibration=None, **kw)
        calibrated = tsearch.auto_plan(TG, calibration=cal, **kw)
        t_stock = predict_plan(stock, calibration=cal).t_runtime
        t_cal = predict_plan(calibrated, calibration=cal).t_runtime
        assert t_cal <= t_stock
        # refine() put the truth-fastest of the calibrated top 4 first
        head = tsearch.search_plans(TG, None, device="cpu", top_k=4,
                                    calibration=cal)
        assert t_cal == min(truth(TG, p) for p in head)


def test_fitted_kernel_win_admits_it_off_the_card():
    store = tcal.CalibrationStore()
    _record(store, [(dict(stage="stage.backproject", impl=impl), 1e-3,
                     1e-3 * ratio) for impl, ratio in
                    (("kernel", 0.5), ("reference", 4.0)) for _ in range(3)])
    cal = store.fit()
    assert cal.admits_impl("kernel")
    assert tsearch.admitted_impls(cal, "cpu") == ("factorized", "kernel")
    plan = tsearch.auto_plan(TG, calibration=cal, device="cpu")
    assert plan.impl in ("factorized", "kernel")
