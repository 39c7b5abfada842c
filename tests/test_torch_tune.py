"""The port's launch-shape tuner (`repro_torch.kernels.backproject.tune`)
and the kernel's launch-shape model, on the CPU.

Ports of `tests/test_precision.py::TestAutotuner` and `::TestFileBackedCache`
for the Hopper search space (tile x staging bytes under a shared-memory
budget), plus: the staging model (`kernel.staging_stats`) against the
footprint rule tile by tile, the port's and the reference's entries in one
tuning-cache file, measured mode refusing CPU tensors, and the plan's
`blocks`/`vmem_budget` fields. The card-side checks (every tile against
the plain version, the model's direct count against the kernel's, measured
tuning) are in test_torch_gpu.py.
"""
import json

import pytest
import torch

from repro.kernels.backproject import tune as jtune
from repro_torch.core.geometry import default_geometry, projection_matrices
from repro_torch.core.plan import ReconstructionPlan, plan_from_spec
from repro_torch.core.backprojection import backproject_factorized
from repro_torch.kernels.backproject import kernel as bpk
from repro_torch.kernels.backproject import tune
from repro_torch.kernels.backproject.ops import (
    backproject_kernel, kernel_operands)

torch.set_num_threads(1)

G = default_geometry(16)
PM = torch.as_tensor(projection_matrices(G))
ARGS = (G.n_x, G.n_y, G.n_z, PM, G.n_u, G.n_v)
DTYPES = [torch.float32, torch.bfloat16, torch.float16,
          torch.float8_e4m3fn, torch.float8_e5m2]


@pytest.fixture(autouse=True)
def _fresh_memo():
    tune.clear_cache()
    yield
    tune.clear_cache()


class TestAutotuner:
    @pytest.mark.parametrize("budget", [24 * 1024, 64 * 1024, 232_448])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
    def test_candidates_tile_and_fit_budget(self, dtype, budget):
        cands = tune.candidate_blocks(dtype, budget)
        assert cands
        for c in cands:
            assert c.tile in bpk.TILES
            assert c.smem == bpk.smem_bytes(c.tile, c.stage_bytes, dtype)
            assert c.smem <= budget
        assert {c.stage_bytes for c in cands} <= set(
            tune.stage_candidates(dtype))

    def test_low_precision_widens_feasible_set(self):
        """A 16-bit wire stages the same pixels in half the bytes, so a
        tight budget admits strictly more candidates."""
        budget = bpk.smem_bytes((8, 8, 64), None, torch.float32) - 1
        n32 = len(tune.candidate_blocks(torch.float32, budget))
        n16 = len(tune.candidate_blocks(torch.float16, budget))
        assert n16 > n32

    def test_budget_too_small_raises(self):
        with pytest.raises(ValueError, match="shared-memory budget"):
            tune.autotune(*ARGS, budget=1024)

    def test_too_small_default_budget_warns_and_runs(self, monkeypatch):
        monkeypatch.setattr(tune, "DEFAULT_SMEM_BUDGET", 1024)
        with pytest.warns(UserWarning, match="no back-projection launch"):
            cfg = tune.autotune(*ARGS, strict=False)
        assert cfg.smem == tune.min_smem_bytes(torch.float32)
        assert cfg.stage_bytes == 0

    def test_pick_is_cached(self):
        a = tune.autotune(*ARGS)
        assert len(tune.cache_info()) == 1
        b = tune.autotune(*ARGS)
        assert a is b
        # another wire dtype, or other matrices at the same shapes, is
        # another tuning key (the kernel's time depends on P)
        tune.autotune(*ARGS, qt_dtype=torch.bfloat16)
        tune.autotune(G.n_x, G.n_y, G.n_z, PM.flip(0), G.n_u, G.n_v)
        assert len(tune.cache_info()) == 3

    def test_measured_mode_on_the_cpu_raises(self, monkeypatch):
        with pytest.raises(ValueError, match="no kernel to time"):
            tune.autotune(*ARGS, measure=True)
        monkeypatch.setenv("REPRO_BP_AUTOTUNE", "time")
        with pytest.raises(ValueError, match="no kernel to time"):
            tune.pick_blocks(*ARGS)

    def test_pins_are_kept(self):
        cfg = tune.autotune(*ARGS, fix_tile=(4, 8, 64))
        assert cfg.tile == (4, 8, 64)
        cfg = tune.autotune(*ARGS, fix_stage=0)
        assert cfg.stage_bytes == 0
        with pytest.raises(ValueError, match="not compiled"):
            tune.autotune(*ARGS, fix_tile=(8, 8, 16))

    def test_default_launch_kept_within_the_margin(self):
        """Unmeasured, the model displaces the source's default launch
        only for a modeled gain above DEFAULT_MARGIN."""
        cfg = tune.autotune(*ARGS)
        dflt = tune.default_config(torch.float32)
        if cfg.as_tuple() != dflt.as_tuple():
            ranked = tune._rank(tune.candidate_blocks(torch.float32),
                                tune._pmat_rows(PM),
                                (G.n_x, G.n_y, G.n_z, G.n_u, G.n_v),
                                torch.float32)
            cost = {c.as_tuple(): c.cost for c in ranked}
            assert cost[cfg.as_tuple()] * (1 + tune.DEFAULT_MARGIN) < \
                cost[dflt.as_tuple()]

    @pytest.mark.parametrize("t", bpk.TILES)
    def test_kernel_uses_tuned_launch(self, t):
        """The tile only changes the launch, never the math: on the CPU
        every launch shape gives the plain version's volume, the oracle's
        within the existing kernel tolerance."""
        q = torch.randn((G.n_proj, G.n_v, G.n_u),
                        generator=torch.Generator().manual_seed(0))
        want = backproject_factorized(PM, q, G.n_x, G.n_y, G.n_z)
        got = backproject_kernel(PM, q, G.n_x, G.n_y, G.n_z, tile=t,
                                 stage_bytes=0)
        auto = backproject_kernel(PM, q, G.n_x, G.n_y, G.n_z)
        scale = float(want.abs().max())
        for out in (got, auto):
            assert float((out - want).abs().max()) / scale < 1e-5

    def test_min_smem_is_the_smallest_static_table(self):
        smallest = min(bpk.static_smem_bytes(t) for t in bpk.TILES)
        for dtype in DTYPES:
            assert tune.min_smem_bytes(dtype) == smallest


class TestStagingModel:
    """`staging_stats`, the tuner's model, is the kernel's staging rule:
    tile by tile it agrees with `footprint_boxes` and the kernel's box
    arithmetic (`prepare` in csrc/backproject.cu)."""

    @staticmethod
    def _brute(params, g, t, stage_bytes, dtype):
        nzh = g.n_z // 2
        vec = bpk.copy_elems(g.n_v, dtype)
        buf = bpk._buf_elems(bpk.default_stage_bytes(dtype)
                             if stage_bytes is None else stage_bytes,
                             dtype.itemsize)
        out = {"direct": 0, "staged": 0, "empty": 0, "staged_bytes": 0}
        for i0 in range(0, g.n_x, t[0]):
            for j0 in range(0, g.n_y, t[1]):
                for k0 in range(0, nzh, t[2]):
                    hi = (min(i0 + t[0], g.n_x) - 1,
                          min(j0 + t[1], g.n_y) - 1, min(k0 + t[2], nzh) - 1)
                    boxes, zpos = bpk.footprint_boxes(
                        params, g.n_u, g.n_v, (i0, j0, k0), hi)
                    for row, zp in zip(boxes.tolist(), zpos.tolist()):
                        rlo, rhi, cfl, cfh, cml, cmh = row
                        front, mirror = cfl <= cfh, cml <= cmh
                        rows = rhi - rlo + 3
                        cf, cm = (cfl - 1) & -vec, (cml - 1) & -vec
                        width = max(cfh + 2 - cf if front else 0,
                                    cmh + 2 - cm if mirror else 0)
                        pitch = (width + vec - 1) & -vec
                        nonempty = rlo <= rhi and (front or mirror)
                        if not zp or (nonempty and 2 * rows * pitch > buf):
                            out["direct"] += 1
                        elif nonempty:
                            out["staged"] += 1
                            out["staged_bytes"] += (2 * rows * pitch
                                                    * dtype.itemsize)
                        else:
                            out["empty"] += 1
        return out

    @pytest.mark.parametrize("stage_bytes", [None, 0, 3000])
    @pytest.mark.parametrize("t", bpk.TILES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn])
    def test_matches_the_footprint_rule(self, t, stage_bytes, dtype):
        # a geometry whose boxes leave the detector on some tiles and
        # partial tiles on every axis
        g = default_geometry(20, n_proj=6)
        params, _ = kernel_operands(
            projection_matrices(g), torch.zeros(g.proj_shape()))
        got = bpk.staging_stats(params, g.n_u, g.n_v, g.n_x, g.n_y,
                                g.n_z // 2, t, stage_bytes, dtype)
        want = self._brute(params, g, t, stage_bytes, dtype)
        assert {k: got[k] for k in want} == want
        assert got["pairs"] == got["direct"] + got["staged"] + got["empty"]

    def test_smem_model(self):
        assert bpk.static_smem_bytes((8, 8, 64)) == 80 * 64 + 128
        assert bpk.smem_bytes((8, 8, 64), None, torch.float32) == \
            80 * 64 + 128 + bpk.STAGE_PIXELS * 4
        assert bpk.smem_bytes((8, 8, 64), 0, torch.float16) == 80 * 64 + 128


class TestFileBackedCache:
    """The tuner memo persists to a JSON file (REPRO_TUNE_CACHE)."""

    def test_survives_in_process_memo_clear(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
        hits0 = tune.file_cache_hits()
        a = tune.autotune(*ARGS)
        assert (tmp_path / "tc.json").exists()
        tune.clear_cache()  # drop the memo; the file must refill it
        b = tune.autotune(*ARGS)
        assert tune.file_cache_hits() == hits0 + 1
        assert b == a

    def test_measured_entry_satisfies_unmeasured(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
        tune.autotune(*ARGS)
        (key, _), = tune.cache_info().items()
        timed = tune.BlockConfig((4, 8, 64), 0, tune.min_smem_bytes(),
                                 elapsed=1e-3)
        tune._file_cache_put(key, timed)
        tune.clear_cache()
        assert tune.autotune(*ARGS) == timed

    @pytest.mark.parametrize("value", ["off", "0", "", "none"])
    def test_disabled_by_env(self, tmp_path, monkeypatch, value):
        monkeypatch.setenv("REPRO_TUNE_CACHE", value)
        monkeypatch.chdir(tmp_path)
        assert tune.cache_path() is None
        tune.autotune(*ARGS)
        assert not list(tmp_path.iterdir())

    def test_corrupt_cache_file_is_ignored(self, tmp_path, monkeypatch):
        path = tmp_path / "tc.json"
        path.write_text("{not json")
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
        cfg = tune.autotune(*ARGS)
        assert cfg.smem <= tune.DEFAULT_SMEM_BUDGET  # recomputed fine

    def test_port_and_reference_keys_do_not_collide(self, tmp_path,
                                                    monkeypatch):
        """Both packages' tuners on one file: each entry stays in its own
        key space (the port's keys lead with "hopper" and the device)."""
        path = tmp_path / "tc.json"
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
        jtune.clear_cache()
        jtune.autotune(16, 16, 16, 8, 24, 24, measure=False)
        tune.autotune(*ARGS)
        entries = json.loads(path.read_text())["entries"]
        keys = [json.loads(k) for k in entries]
        assert len(keys) == 2
        ours = [k for k in keys if k[0] == "hopper"]
        assert len(ours) == 1 and ours[0][1] == "cpu"
        j_hits, t_hits = jtune.file_cache_hits(), tune.file_cache_hits()
        jtune.clear_cache()
        tune.clear_cache()
        assert jtune.autotune(16, 16, 16, 8, 24, 24, measure=False).bi > 0
        assert tune.autotune(*ARGS).tile in bpk.TILES
        assert (jtune.file_cache_hits(), tune.file_cache_hits()) == \
            (j_hits + 1, t_hits + 1)
        jtune.clear_cache()


class TestPlanLaunchFields:
    def test_resolved_launch_reaches_the_engine(self):
        plan = ReconstructionPlan(geometry=G, impl="kernel", device="cpu",
                                  blocks=(4, 8, 64), vmem_budget=64 * 1024)
        t, sb = plan.resolved_launch()
        assert t == (4, 8, 64) == plan.resolved_blocks()
        assert bpk.smem_bytes(t, sb, torch.float32) <= 64 * 1024
        desc = plan.describe()
        assert (desc["blocks"], desc["stage_bytes"]) == (t, sb)
        assert plan.build().__wrapped__ is not None
        assert ReconstructionPlan(geometry=G, device="cpu").describe()[
            "blocks"] is None

    @pytest.mark.parametrize("fields,match", [
        ({"blocks": (8, 8, 16)}, "not a compiled tile"),
        ({"blocks": (8, 8, 64), "impl": "factorized"},
         "only applies to impl='kernel'"),
        ({"vmem_budget": 2048}, "fits no launch shape"),
    ])
    def test_validate_rejects(self, fields, match):
        kw = dict(impl="kernel")
        kw.update(fields)
        with pytest.raises(ValueError, match=match):
            ReconstructionPlan(geometry=G, device="cpu", **kw).validate()

    def test_spec_keys_parse_as_in_the_reference(self):
        plan = plan_from_spec(G, "impl=kernel,blocks=16:8:32,"
                              "vmem_budget=65536", device="cpu")
        assert plan.blocks == (16, 8, 32) and plan.vmem_budget == 65536
        assert plan.validate().resolved_blocks() == (16, 8, 32)

