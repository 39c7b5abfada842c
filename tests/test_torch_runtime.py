"""Port parity for `repro_torch.runtime`: the reference's fault-tolerance
and elastic cases of tests/test_checkpoint.py on the port, plus:

* `ResumableReconstruction` whose step folds micro-batch b through the
  back-projection kernel (its plain version on the CPU) with the calls the
  streaming session makes per delta (`stage`, then `_fold`): killed at a
  batch and resumed from its checkpoint, BIT-equal to an uninterrupted
  run, and within 1e-5 of the max of the JAX package's resumable run (its
  session's stage and fold) on the same numpy inputs.
* `plan_remesh` equal to the reference's for every rank count 1-512.
* `build_mesh` on a gloo world of one in this process.
"""
import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro.runtime import ResumableReconstruction as JaxResumable
from repro.runtime import plan_remesh as jplan_remesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.fdk import fdk_scale
from repro_torch.core.geometry import CBCTGeometry
from repro_torch.core.plan import ReconstructionPlan
from repro_torch.runtime import (
    ElasticPlan, ResumableReconstruction, StragglerMonitor, build_mesh,
    plan_remesh, restart_loop,
)

torch.set_num_threads(1)

JG = jgeo.default_geometry(16, n_proj=16)
G = CBCTGeometry(**dataclasses.asdict(JG))
N_BATCHES = 8
REL = 1e-5


@pytest.fixture(scope="module")
def proj():
    return np.array(jph.forward_project(JG))


def _span(b):
    n = G.n_proj // N_BATCHES
    return b * n, (b + 1) * n


def torch_step(proj):
    """step_fn(acc, b): micro-batch b folded through the kernel's plain
    version, by the session's own per-delta calls."""
    sess = ReconstructionPlan(geometry=G, impl="kernel", precision="fp32",
                              schedule="incremental", n_steps=N_BATCHES,
                              device="cpu").build_incremental()

    def step(acc, b):
        lo, hi = _span(b)
        staged = sess.stage(torch.as_tensor(proj[lo:hi]), (lo, hi))
        sess._acc = acc
        sess._fold(staged.pm_col, staged.q_col, staged.sc_col)
        return sess._acc
    return step


def test_resumed_kernel_run_is_bit_equal_to_an_uninterrupted_one(
        tmp_path, proj):
    step = torch_step(proj)
    zeros = torch.zeros(G.volume_shape())
    want = ResumableReconstruction(step, zeros, N_BATCHES).run()
    mgr = CheckpointManager(str(tmp_path))
    r1 = ResumableReconstruction(step, zeros, N_BATCHES, mgr,
                                 checkpoint_every=2)
    with pytest.raises(RuntimeError, match="injected"):
        r1.run(fail_at=5)
    r2 = ResumableReconstruction(step, zeros, N_BATCHES, mgr,
                                 checkpoint_every=2)
    r2.resume()
    assert r2.state.cursor == 4
    assert r2.state.accumulator.device == zeros.device
    got = r2.run()
    assert torch.equal(got, want)
    assert torch.equal(zeros, torch.zeros_like(zeros))   # steps are pure


def test_resumable_run_matches_the_jax_package(tmp_path, proj):
    step = torch_step(proj)
    got = ResumableReconstruction(step, torch.zeros(G.volume_shape()),
                                  N_BATCHES).run() * fdk_scale(G)
    sess = jplan.ReconstructionPlan(
        geometry=JG, impl="kernel", precision="fp32", schedule="incremental",
        n_steps=N_BATCHES).build_incremental()

    def jstep(acc, b):
        lo, hi = _span(b)
        s = sess.stage(jnp.asarray(proj[lo:hi]), (lo, hi))
        return sess._get_fold_fn(hi - lo, with_volume=False)(
            acc, s.pm_col, s.q_col, s.sc_col)

    want = np.asarray(JaxResumable(jstep, jnp.zeros(JG.volume_shape()),
                                   N_BATCHES).run()) * fdk_scale(G)
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err < REL, err
    fused = ReconstructionPlan(geometry=G, impl="kernel", precision="fp32",
                               device="cpu").build()(proj)
    assert float((got - fused).abs().max() / fused.abs().max()) < REL


class TestFaultTolerance:
    def test_resumable_reconstruction_survives_fault(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        step_fn = lambda acc, b: acc + (b + 1.0)  # noqa: E731
        r1 = ResumableReconstruction(step_fn, torch.zeros((3,)), 8, mgr,
                                     checkpoint_every=2)
        with pytest.raises(RuntimeError):
            r1.run(fail_at=5)
        r2 = ResumableReconstruction(step_fn, torch.zeros((3,)), 8, mgr,
                                     checkpoint_every=2)
        r2.resume()
        assert r2.state.cursor == 4  # resumed from the last committed batch
        out = r2.run()
        np.testing.assert_allclose(out.numpy(), float(sum(range(1, 9))))

    def test_resume_without_a_checkpoint_starts_at_zero(self, tmp_path):
        r = ResumableReconstruction(lambda acc, b: acc + 1.0,
                                    torch.zeros((2,)), 3,
                                    CheckpointManager(str(tmp_path)))
        r.resume()
        assert r.state.cursor == 0
        assert torch.equal(r.run(), torch.full((2,), 3.0))

    def test_restart_loop_exact_result_after_failures(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state = restart_loop(
            lambda: {"x": np.float64(0.0)},
            lambda s, i: {"x": s["x"] + i},
            n_steps=20, manager=mgr, checkpoint_every=5, fail_at={7, 13},
            device="cpu")
        assert float(state["x"]) == float(sum(range(20)))

    def test_restart_loop_gives_up_after_max_failures(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(RuntimeError):
            restart_loop(
                lambda: {"x": np.float64(0.0)},
                lambda s, i: (_ for _ in ()).throw(RuntimeError("boom")),
                n_steps=5, manager=mgr, max_failures=2, device="cpu")

    def test_restart_loop_counts_failures_to_the_bound(self, tmp_path):
        """max_failures injected faults are survived; one more is not."""
        calls = []

        def flaky(s, i):
            calls.append(i)
            if len(calls) <= 3:
                raise RuntimeError("flaky")
            return {"x": s["x"] + 1.0}

        state = restart_loop(lambda: {"x": np.float64(0.0)}, flaky,
                             n_steps=4, manager=CheckpointManager(
                                 str(tmp_path / "a")),
                             max_failures=3, device="cpu")
        assert float(state["x"]) == 4.0
        calls.clear()
        with pytest.raises(RuntimeError, match="flaky"):
            restart_loop(lambda: {"x": np.float64(0.0)}, flaky, n_steps=4,
                         manager=CheckpointManager(str(tmp_path / "b")),
                         max_failures=2, device="cpu")

    @pytest.mark.parametrize("call", [
        lambda mgr: mgr.restore_latest({"x": torch.zeros(1)}),
        lambda mgr: restart_loop(lambda: {"x": torch.zeros(1)},
                                 lambda s, i: s, n_steps=1, manager=mgr)])
    def test_restores_default_to_the_card(self, tmp_path, call):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call(CheckpointManager(str(tmp_path)))

    def test_straggler_monitor(self):
        mon = StragglerMonitor(threshold=2.0)
        flags = [mon.record(t) for t in [1.0, 1.1, 0.9, 5.0, 1.0]]
        assert flags == [False, False, False, True, False]
        hint = mon.rebalance_hint(n_batches=4, n_ranks=8)
        assert hint["micro_batches"] >= 8
        assert hint["flagged_steps"][0][0] == 3

    def test_straggler_does_not_pollute_ema(self):
        mon = StragglerMonitor(threshold=2.0)
        for t in [1.0, 1.0, 10.0, 1.0, 1.0]:
            mon.record(t)
        assert mon.ema < 1.5

    def test_straggler_timed_returns_the_output(self):
        mon = StragglerMonitor()
        out, slow = mon.timed(torch.add, torch.ones(3), 1.0)
        assert torch.equal(out, torch.full((3,), 2.0))
        assert slow is False and mon.ema is not None
        assert mon.rebalance_hint(4, 2) == {"micro_batches": 4,
                                            "flagged_steps": []}


class TestElastic:
    def test_plan_remesh_full(self):
        plan = plan_remesh(list(range(512)), model_parallel=16, want_pods=2)
        assert plan.mesh_shape == (2, 16, 16)
        assert plan.dropped_devices == 0

    def test_plan_remesh_after_node_loss(self):
        plan = plan_remesh(list(range(508)), model_parallel=16, want_pods=2)
        assert plan.mesh_shape == (2, 15, 16)
        assert plan.dropped_devices == 508 - 2 * 15 * 16

    def test_plan_remesh_single_pod(self):
        plan = plan_remesh(list(range(100)), model_parallel=8)
        assert plan.mesh_shape == (12, 8)

    def test_insufficient_devices(self):
        with pytest.raises(ValueError):
            plan_remesh(list(range(4)), model_parallel=16)

    @pytest.mark.parametrize("want_pods", [None, 1, 2, 4])
    @pytest.mark.parametrize("model_parallel", [1, 2, 3, 8, 16])
    def test_plan_remesh_equals_the_reference(self, model_parallel,
                                              want_pods):
        for n in range(model_parallel, 513):
            got = plan_remesh(list(range(n)), model_parallel, want_pods)
            want = jplan_remesh(list(range(n)), model_parallel, want_pods)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), n

    def test_build_mesh_on_a_world_of_one(self, tmp_path):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            for plan in (plan_remesh([0], 1), plan_remesh([0], 1, 1),
                         ElasticPlan((1, 1, 1), ("pod", "data", "model"),
                                     0)):
                mesh = build_mesh([0], plan, device_type="cpu")
                assert tuple(mesh.shape) == plan.mesh_shape
                assert tuple(mesh.mesh_dim_names) == plan.axis_names
                assert tuple(mesh.get_coordinate()) == (0,) * len(
                    plan.mesh_shape)
        finally:
            dist.destroy_process_group()
