"""Port parity for `repro_torch.service` (admission, bucketing, plan-cache
amortization, async I/O, failure isolation): the reference's
tests/test_service.py classes on the port with device="cpu", at its 16^3
geometry; the mesh cases on a (1, 1, 1) gloo mesh over a world of one in
this process. Against the JAX package's service on the same numpy scans and
spec: lanes within 1e-5 of the max of its volumes, and its plan-cache
searches and bucket count. A bucket of n scans runs exactly n lanes (the
reference pads it to a power of two). Every lane is BIT-equal to the
family plan's `build()`. The serve loop, scheduling policies and SLOs are
tests/test_torch_service_loop.py.
"""
import contextlib
import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import service as jservice
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro_torch.core.geometry import CBCTGeometry
from repro_torch.core.plan import clear_engine_cache, plan_from_spec
from repro_torch.io import PrefetchError, ProjectionSource, VolumeSink
from repro_torch.obs.trace import Tracer, set_tracer
from repro_torch.parallel.mesh import make_mesh
from repro_torch.planner import DEFAULT_HBM_BYTES
from repro_torch.service import (
    AdmissionError, QueueFullError, ReconstructionService, ScanFamily,
    TicketState,
)

torch.set_num_threads(1)

CPU = "cpu"
REL = 1e-5
JG = jgeo.default_geometry(16, n_proj=8)
G = CBCTGeometry(**dataclasses.asdict(JG))


@pytest.fixture(scope="module")
def case16():
    """The reference's five scans (its seed), as numpy."""
    base = np.asarray(jph.forward_project(JG))
    rng = np.random.default_rng(3)
    return G, [(base * (1.0 + 0.25 * k)
                + rng.standard_normal(base.shape).astype(np.float32) * 0.01)
               for k in range(5)]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1, 1) (pod, data, model) mesh over a gloo world of one."""
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1, 1), ("pod", "data", "model"), device_type=CPU)
    finally:
        clear_engine_cache()
        dist.destroy_process_group()


def service(mesh=None, **kw):
    return ReconstructionService(mesh, device=CPU, **kw)


def plan_of(g, mesh=None, **pins):
    return plan_from_spec(g, "auto", mesh=mesh, device=CPU, **pins)


@contextlib.contextmanager
def lanes_run():
    """The lanes of each batched engine call made inside, in order (the
    ``engine.batched`` spans of a tracer of its own)."""
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    lanes = []
    try:
        yield lanes
    finally:
        set_tracer(prev)
        lanes.extend(e["args"]["lanes"]
                     for e in tracer.spans("engine.batched"))


class ExplodingSource:
    def load(self, mesh=None, device="cuda"):
        raise IOError("bad shard")


class TestServeAndBucket:
    def test_drain_is_bitexact_vs_single_scan_engine(self, case16, mesh):
        g, scans = case16
        clear_engine_cache()
        svc = service(mesh, max_batch=8)
        tickets = [svc.submit(projections=p, geometry=g) for p in scans]
        with lanes_run() as lanes:
            served = svc.drain()
        assert [t.scan_id for t in served] == [t.scan_id for t in tickets]
        assert all(t.state is TicketState.DONE for t in tickets)
        ref = plan_of(g, mesh).build()
        for p, t in zip(scans, tickets):
            assert torch.equal(ref(p), t.result())
        st = svc.stats()
        # 5 scans -> one bucket that runs exactly its 5 lanes
        assert st["buckets"] == 1 and lanes == [5]
        assert st["served"] == 5 and st["queued"] == 0
        svc.close()

    @pytest.mark.parametrize("pins", [
        {"impl": "kernel", "precision": "fp32"},
        {"impl": "kernel", "precision": "fp16"},
        {"impl": "factorized", "precision": "fp8_e4m3"}])
    def test_lanes_bit_equal_to_the_family_plan(self, case16, pins):
        g, scans = case16
        svc = service(max_batch=4)
        tickets = [svc.submit(projections=p, geometry=g, **pins)
                   for p in scans[:3]]
        with lanes_run() as lanes:
            svc.drain()
        build = svc.plan_cache.resolve(tickets[0].family).build()
        for p, t in zip(scans, tickets):
            assert t.done and torch.equal(build(p), t.result())
        assert lanes == [3]
        svc.close()

    def test_plan_cache_amortizes_planner_search(self, case16):
        """The second same-family request does ZERO planner-search work —
        the searches counter stays at 1."""
        g, scans = case16
        svc = service(max_batch=4)
        svc.submit(projections=scans[0], geometry=g)
        svc.drain()
        assert svc.stats()["plan_cache"]["searches"] == 1
        svc.submit(projections=scans[1], geometry=g)
        svc.drain()
        st = svc.stats()
        assert st["plan_cache"]["searches"] == 1      # no new search
        assert st["plan_cache"]["hits"] >= 1
        # a pinned request is a NEW family -> exactly one more search
        svc.submit(projections=scans[2], geometry=g, precision="bf16")
        svc.drain()
        assert svc.stats()["plan_cache"]["searches"] == 2
        svc.close()

    def test_families_never_share_a_bucket(self, case16):
        g, scans = case16
        svc = service(max_batch=8)
        t1 = svc.submit(projections=scans[0], geometry=g)
        t2 = svc.submit(projections=scans[1], geometry=g, precision="bf16")
        svc.drain()
        assert svc.stats()["buckets"] == 2
        assert t1.family != t2.family
        assert t1.done and t2.done
        svc.close()

    def test_max_batch_splits_buckets(self, case16):
        g, scans = case16
        svc = service(max_batch=2)
        for p in scans:                       # 5 scans, cap 2
            svc.submit(projections=p, geometry=g)
        with lanes_run() as lanes:
            tickets = svc.drain()
        assert all(t.done for t in tickets)
        st = svc.stats()
        assert st["buckets"] == 3             # 2 + 2 + 1
        assert lanes == [2, 2, 1]
        svc.close()

    def test_budget_caps_the_bucket(self, case16):
        """A budget of two scans' footprint caps the buckets at 2."""
        from repro_torch.planner import plan_footprint, point_from_plan
        g, scans = case16
        fp = plan_footprint(g, point_from_plan(plan_of(g))).total
        svc = service(max_batch=8, hbm_bytes=2 * fp + 1)
        for p in scans:
            svc.submit(projections=p, geometry=g)
        with lanes_run() as lanes:
            svc.drain()
        assert svc.stats()["buckets"] == 3 and lanes == [2, 2, 1]
        svc.close()

    def test_a_bucket_filters_only_its_scans(self, case16, monkeypatch):
        """5 same-family scans under max_batch 8 are filtered as 5 scans
        are, not as a bucket of 8: no lane runs for a scan not sent."""
        from repro_torch.core import filtering as tfilt
        g, scans = case16
        calls = []
        real = tfilt._filter_batch

        def spy(proj, *args, **kwargs):
            calls.append(proj.shape[0])
            return real(proj, *args, **kwargs)

        monkeypatch.setattr(tfilt, "_filter_batch", spy)
        svc = service(max_batch=8)
        tickets = [svc.submit(projections=p, geometry=g) for p in scans]
        svc.plan_cache.resolve(tickets[0].family).build()(scans[0])
        per_scan, calls[:] = list(calls), []
        svc.drain()
        assert all(t.done for t in tickets)
        assert per_scan and calls == per_scan * 5
        svc.close()

    def test_new_bucket_sizes_make_no_stages(self, case16, monkeypatch):
        """Buckets of 1, then 3, then 5 scans of one family compose the
        family plan's stages once: a bucket size not served before costs
        no tuner pick, filter tables or projection matrices."""
        from repro_torch.core.plan import ReconstructionPlan
        g, scans = case16
        clear_engine_cache()
        made = []
        real = ReconstructionPlan._make_stages

        def spy(plan):
            made.append(plan)
            return real(plan)

        monkeypatch.setattr(ReconstructionPlan, "_make_stages", spy)
        svc = service(max_batch=8)
        for n in (1, 3, 5):
            tickets = [svc.submit(projections=p, geometry=g)
                       for p in scans[:n]]
            with lanes_run() as lanes:
                svc.drain()
            assert lanes == [n] and all(t.done for t in tickets)
        assert made == [svc.plan_cache.resolve(tickets[0].family)]
        svc.close()


class TestAgainstTheJaxService:
    """The same scans, spec and budget through both packages' services."""

    @staticmethod
    def _run(svc, scans, g, pins_list):
        tickets = [svc.submit(projections=p, geometry=g, **pins)
                   for p in scans for pins in pins_list]
        order = [t.scan_id for t in svc.drain()]
        st = svc.stats()
        svc.close()
        return tickets, order, st

    @pytest.mark.parametrize("pins", [{"precision": "fp32"},
                                      {"impl": "kernel",
                                       "precision": "fp32"}])
    def test_volumes_match_the_jax_service(self, case16, pins):
        g, scans = case16
        got, _, _ = self._run(service(max_batch=4), scans[:3], g, [pins])
        want, _, _ = self._run(jservice.ReconstructionService(max_batch=4),
                               [jnp.asarray(p) for p in scans[:3]], JG,
                               [pins])
        for a, b in zip(got, want):
            a, b = a.result().numpy(), np.asarray(b.result())
            assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < REL

    @pytest.mark.parametrize("max_batch", [1, 2, 8])
    def test_counts_match_the_jax_service(self, case16, max_batch):
        """Submitted, served and bucket counts, the order and the planner
        searches match; the reference's padded_lanes count has no
        counterpart, since the port runs no pad lanes."""
        g, scans = case16
        pins_list = [{}, {"precision": "bf16"}]
        _, order, st = self._run(service(max_batch=max_batch), scans, g,
                                 pins_list)
        _, jorder, jst = self._run(
            jservice.ReconstructionService(max_batch=max_batch), scans, JG,
            pins_list)
        assert order == jorder
        for k in ("submitted", "served", "buckets"):
            assert st[k] == jst[k], k
        assert st["plan_cache"]["searches"] == jst["plan_cache"]["searches"]

    def test_plans_match_the_jax_service(self, case16):
        g, _ = case16
        svc = service()
        jsvc = jservice.ReconstructionService()
        for pins in ({}, {"precision": "bf16"}, {"impl": "kernel"}):
            got = svc.plan_cache.resolve(ScanFamily.make(g, None, pins))
            want = jsvc.plan_cache.resolve(
                jservice.ScanFamily.make(JG, None, pins))
            for k in ("schedule", "impl", "precision", "n_steps", "reduce"):
                w = getattr(want, k)
                assert getattr(got, k) == getattr(w, "storage", w), (pins, k)
        svc.close()
        jsvc.close()


class TestAdmission:
    def test_footprint_over_budget_rejected(self, case16):
        g, scans = case16
        svc = service(hbm_bytes=1024)
        with pytest.raises(AdmissionError, match="budget"):
            svc.submit(projections=scans[0], geometry=g)
        assert svc.queued == 0
        svc.close()

    def test_queue_full_backpressure(self, case16):
        g, scans = case16
        svc = service(max_queue=1)
        svc.submit(projections=scans[0], geometry=g)
        with pytest.raises(QueueFullError):
            svc.submit(projections=scans[1], geometry=g)
        assert svc.queued == 1
        svc.drain()
        svc.submit(projections=scans[1], geometry=g)   # drained -> space
        svc.close()

    def test_shape_mismatch_rejected(self, case16):
        g, _ = case16
        svc = service()
        with pytest.raises(AdmissionError, match="shape"):
            svc.submit(projections=torch.zeros((1, 2, 3)), geometry=g)
        svc.close()

    def test_exactly_one_data_source(self, case16):
        g, scans = case16
        svc = service()
        with pytest.raises(AdmissionError, match="exactly one"):
            svc.submit(geometry=g)
        with pytest.raises(AdmissionError, match="exactly one"):
            svc.submit(projections=scans[0], source=object(), geometry=g)
        svc.close()

    def test_incremental_schedule_pin_rejected_at_submit(self, case16):
        g, scans = case16
        svc = service()
        with pytest.raises(AdmissionError, match="incremental"):
            svc.submit(projections=scans[0], geometry=g,
                       schedule="incremental")
        assert svc.queued == 0
        assert svc.stats()["rejected"] == 1
        svc.close()

    def test_every_rejection_path_counts(self, case16):
        g, scans = case16
        svc = service(max_queue=1)
        with pytest.raises(AdmissionError, match="shape"):
            svc.submit(projections=torch.zeros((1, 2, 3)), geometry=g)
        with pytest.raises(AdmissionError, match="exactly one"):
            svc.submit(geometry=g)
        svc.submit(projections=scans[0], geometry=g)
        with pytest.raises(QueueFullError):
            svc.submit(projections=scans[1], geometry=g)
        assert svc.stats()["rejected"] == 3
        svc.close()
        svc = service(hbm_bytes=1024)
        with pytest.raises(AdmissionError, match="budget"):
            svc.submit(projections=scans[0], geometry=g)
        assert svc.stats()["rejected"] == 1
        svc.close()

    def test_result_before_drain_raises(self, case16):
        g, scans = case16
        svc = service()
        t = svc.submit(projections=scans[0], geometry=g)
        with pytest.raises(RuntimeError, match="queued"):
            t.result()
        svc.close()

    def test_cpu_budget_is_the_reference_default(self):
        svc = service()
        assert svc.hbm_bytes == DEFAULT_HBM_BYTES
        assert svc.device == torch.device(CPU)
        svc.close()

    def test_the_card_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ReconstructionService()


class TestAsyncIO:
    def test_source_and_sink_roundtrip(self, case16, mesh, tmp_path):
        """A stored scan: projections prefetch-read from a shard store,
        volume stored through the sink, both byte-faithful; on the mesh."""
        g, scans = case16
        src = ProjectionSource.write(str(tmp_path / "scan"), scans[0])
        sink = VolumeSink(str(tmp_path / "vol"))
        svc = service(mesh)
        t = svc.submit(source=src, geometry=g, sink=sink)
        svc.drain()
        assert t.done
        ref = plan_of(g, mesh).build()(scans[0])
        assert torch.equal(t.result(), ref)
        assert torch.equal(sink.read(), ref)
        st = svc.stats()
        assert st["prefetched_loads"] == 1 and st["writebacks"] == 1
        svc.close()

    @pytest.mark.parametrize("codec", [None, "fp16", "fp8_e4m3"])
    def test_source_lane_is_its_host_load(self, case16, tmp_path, codec):
        """A source lane is read to host memory and decoded there: the
        volume is build() of that load, and the write-behind sink holds it."""
        g, scans = case16
        src = ProjectionSource.write(str(tmp_path / "scan"), scans[1],
                                     codec=codec)
        sink = VolumeSink(str(tmp_path / "vol"))
        svc = service()
        t = svc.submit(source=src, geometry=g, sink=sink, impl="kernel")
        svc.drain()
        ref = svc.plan_cache.resolve(t.family).build()(
            src.load(device=CPU))
        assert torch.equal(t.result(), ref)
        assert torch.equal(sink.read(), ref)
        svc.close()

    def test_failed_writeback_fails_only_its_ticket(self, case16, tmp_path):
        g, scans = case16

        class ExplodingSink:
            def write(self, volume, layout=None):
                raise IOError("disk full")

        svc = service()
        ok = svc.submit(projections=scans[0], geometry=g,
                        sink=VolumeSink(str(tmp_path / "ok")))
        bad = svc.submit(projections=scans[1], geometry=g,
                         sink=ExplodingSink())
        svc.drain()
        assert ok.state is TicketState.DONE
        assert bad.state is TicketState.FAILED
        with pytest.raises(RuntimeError, match="failed"):
            bad.result()
        assert isinstance(bad.error, IOError)
        st = svc.stats()
        assert st["failed"] == 1 and st["served"] == 1
        svc.close()


class TestFailureIsolation:
    def test_failed_engine_build_does_not_corrupt_next_bucket(
            self, case16, tmp_path):
        """A bucket that fails BEFORE consuming its prefetched loads (plan
        resolve / engine build raising at drain time) must not leave them
        queued — the next bucket's scans would silently reconstruct from
        the wrong scans' data and be DONE."""
        g, scans = case16
        src_a = ProjectionSource.write(str(tmp_path / "a"), scans[0])
        src_b = ProjectionSource.write(str(tmp_path / "b"), scans[1])
        svc = service()
        ta = svc.submit(source=src_a, geometry=g)
        # a pinned request is its own family -> its own (later) bucket
        tb = svc.submit(source=src_b, geometry=g, precision="bf16")
        real_resolve = svc.plan_cache.resolve
        calls = {"a": 0}

        def poisoned(family):
            if family == ta.family:
                calls["a"] += 1
                if calls["a"] > 1:   # bucketing resolve OK, serving fails
                    raise RuntimeError("engine build exploded")
            return real_resolve(family)

        svc.plan_cache.resolve = poisoned
        served = svc.drain()
        svc.plan_cache.resolve = real_resolve
        assert len(served) == 2
        assert ta.state is TicketState.FAILED
        assert isinstance(ta.error, RuntimeError)
        # bucket B served from ITS OWN projections, bit-exact
        assert tb.state is TicketState.DONE
        ref = plan_of(g, precision="bf16").build()(scans[1])
        assert torch.equal(tb.result(), ref)
        st = svc.stats()
        assert st["failed"] == 1 and st["served"] == 1
        svc.close()

    def test_bucket_construction_failure_fails_only_its_family(
            self, case16):
        g, scans = case16
        svc = service()
        ta1 = svc.submit(projections=scans[0], geometry=g)
        ta2 = svc.submit(projections=scans[1], geometry=g)
        tb = svc.submit(projections=scans[2], geometry=g, precision="bf16")
        real_resolve = svc.plan_cache.resolve

        def poisoned(family):
            if family == ta1.family:
                raise RuntimeError("poisoned plan cache")
            return real_resolve(family)

        svc.plan_cache.resolve = poisoned
        served = svc.drain()
        svc.plan_cache.resolve = real_resolve
        assert {t.scan_id for t in served} == {ta1.scan_id, ta2.scan_id,
                                               tb.scan_id}
        assert ta1.state is TicketState.FAILED
        assert ta2.state is TicketState.FAILED
        assert "poisoned" in str(ta1.error) and "poisoned" in str(ta2.error)
        assert tb.state is TicketState.DONE
        ref = plan_of(g, precision="bf16").build()(scans[2])
        assert torch.equal(tb.result(), ref)
        st = svc.stats()
        assert st["failed"] == 2 and st["served"] == 1
        assert st["queued"] == 0
        svc.close()

    def test_failed_load_fails_only_its_bucket(self, case16, tmp_path):
        g, scans = case16
        src_b = ProjectionSource.write(str(tmp_path / "b"), scans[1])
        svc = service()
        ta = svc.submit(source=ExplodingSource(), geometry=g)
        tb = svc.submit(source=src_b, geometry=g, precision="bf16")
        svc.drain()
        assert ta.state is TicketState.FAILED
        assert isinstance(ta.error, PrefetchError)
        assert tb.state is TicketState.DONE
        ref = plan_of(g, precision="bf16").build()(scans[1])
        assert torch.equal(tb.result(), ref)
        svc.close()


class TestScanFamily:
    def test_identity_is_geometry_mesh_pins(self, case16, mesh):
        g, _ = case16
        g2 = dataclasses.replace(g, n_proj=24)
        a = ScanFamily.make(g, mesh, {})
        assert a == ScanFamily.make(g, mesh, {})
        assert a != ScanFamily.make(g2, mesh, {})
        assert a != ScanFamily.make(g, None, {})
        assert a != ScanFamily.make(g, mesh, {"precision": "bf16"})
        # pin order canonicalized
        assert (ScanFamily.make(g, mesh, {"a": 1, "b": 2})
                == ScanFamily.make(g, mesh, {"b": 2, "a": 1}))
        assert hash(a) == hash(ScanFamily.make(g, mesh, {}))
