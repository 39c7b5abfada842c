"""Port parity for `repro_torch.service`'s continuous half: the reference's
tests/test_service.py serve-loop, scheduling-policy, SLO, prefetcher and
write-behind classes on the port with device="cpu" at its 16^3 geometry,
and each policy's execution order equal to the JAX package's service on the
same submissions. Admission, bucketing and I/O are
tests/test_torch_service.py.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro import service as jservice
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro_torch.core.geometry import CBCTGeometry
from repro_torch.core.plan import plan_from_spec
from repro_torch.io import AsyncWriteback, PrefetchError, SourcePrefetcher
from repro_torch.service import (
    QueueFullError, ReconstructionService, TicketState,
)

torch.set_num_threads(1)

CPU = "cpu"
JG = jgeo.default_geometry(16, n_proj=8)
G = CBCTGeometry(**dataclasses.asdict(JG))


@pytest.fixture(scope="module")
def case16():
    base = np.asarray(jph.forward_project(JG))
    rng = np.random.default_rng(3)
    return G, [(base * (1.0 + 0.25 * k)
                + rng.standard_normal(base.shape).astype(np.float32) * 0.01)
               for k in range(5)]


def service(**kw):
    return ReconstructionService(device=CPU, **kw)


def reference_engine(g, **pins):
    return plan_from_spec(g, "auto", device=CPU, **pins).build()


class ExplodingSource:
    def load(self, mesh=None, device="cuda"):
        raise IOError("bad shard")


class TestPrefetcher:
    def test_order_preserved(self):
        def slow():
            time.sleep(0.05)
            return "a"
        pf = SourcePrefetcher([slow, lambda: "b", lambda: "c"],
                              depth=2).start()
        assert [pf.get(), pf.get(), pf.get()] == ["a", "b", "c"]
        with pytest.raises(StopIteration):
            pf.get()
        pf.close()

    def test_depth_bounds_readahead(self):
        started = []

        def job(k):
            def run():
                started.append(k)
                return k
            return run
        pf = SourcePrefetcher([job(k) for k in range(6)], depth=2).start()
        deadline = time.monotonic() + 5.0
        while len(started) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)   # fill: depth queued + 1 blocked in put
        time.sleep(0.05)
        assert len(started) <= 4
        assert [pf.get() for _ in range(6)] == list(range(6))
        pf.close()

    def test_error_propagates_as_prefetch_error(self):
        def boom():
            raise IOError("bad shard")
        pf = SourcePrefetcher([lambda: 1, boom, lambda: 3]).start()
        assert pf.get() == 1
        with pytest.raises(PrefetchError, match="bad shard"):
            pf.get()
        assert pf.get() == 3          # the worker did NOT stop at the error
        with pytest.raises(StopIteration):
            pf.get()
        pf.close()

    def test_get_after_exhaustion_raises_idempotently(self):
        pf = SourcePrefetcher([lambda: 1]).start()
        assert pf.get() == 1
        for _ in range(3):
            with pytest.raises(StopIteration):
                pf.get()
        pf.close()

    def test_get_after_close_raises_stopiteration(self):
        release = threading.Event()

        def slow():
            release.wait(5.0)
            return 1

        pf = SourcePrefetcher([slow, lambda: 2], depth=1).start()
        release.set()
        assert pf.get() == 1
        pf.close()
        for _ in range(2):
            with pytest.raises(StopIteration):
                pf.get()

    def test_persistent_mode_extends_across_batches(self):
        pf = SourcePrefetcher(depth=2, persistent=True).start()
        pf.extend([lambda: "a", lambda: "b"])
        assert [pf.get(), pf.get()] == ["a", "b"]
        pf.extend([lambda: "c"])      # same worker, second drain pass
        assert pf.get() == "c"
        pf.finish()
        with pytest.raises(StopIteration):
            pf.get()
        with pytest.raises(RuntimeError, match="finished"):
            pf.extend([lambda: "d"])
        pf.close()

    def test_one_shot_prefetcher_rejects_extend(self):
        pf = SourcePrefetcher([lambda: 1])
        with pytest.raises(RuntimeError, match="finished"):
            pf.extend([lambda: 2])
        assert pf.get() == 1
        pf.close()


class TestWriteback:
    def test_drain_reraises_first_failure(self):
        class Sink:
            def __init__(self):
                self.wrote = []

            def write(self, volume, layout=None):
                self.wrote.append(volume.clone())

        class Bad:
            def write(self, volume, layout=None):
                raise IOError("enospc")

        wb = AsyncWriteback(max_pending=2)
        good = Sink()
        wb.submit(good, torch.ones((2, 2)))
        wb.submit(Bad(), torch.ones((2, 2)))
        with pytest.raises(IOError, match="enospc"):
            wb.drain()
        assert len(good.wrote) == 1
        wb.close()

    def test_completed_futures_pruned_on_submit(self):
        class Sink:
            def write(self, volume, layout=None):
                pass

        wb = AsyncWriteback(max_pending=2)
        for _ in range(8):
            wb.submit(Sink(), torch.ones((2,))).result()
        assert len(wb._futures) <= 2    # not 8: done futures were pruned
        wb.close()

    def test_backpressure_blocks_at_max_pending(self):
        release = threading.Event()
        wrote = []

        class SlowSink:
            def write(self, volume, layout=None):
                release.wait(5.0)
                wrote.append(1)

        wb = AsyncWriteback(max_pending=1)
        t0 = time.monotonic()
        wb.submit(SlowSink(), torch.ones((2,)))

        def delayed_release():
            time.sleep(0.1)
            release.set()
        threading.Thread(target=delayed_release, daemon=True).start()
        wb.submit(SlowSink(), torch.ones((2,)))   # must wait for slot
        assert time.monotonic() - t0 >= 0.05
        assert wb.drain() >= 1
        assert len(wrote) == 2      # both writes ran
        wb.close()


class TestServeLoop:
    def test_serve_shutdown_roundtrip(self, case16):
        g, scans = case16
        svc = service(max_batch=4).serve()
        assert svc.serving
        tickets = [svc.submit(projections=p, geometry=g) for p in scans]
        for t in tickets:
            assert t.wait(timeout=60.0), t.state
        assert all(t.done for t in tickets)
        ref = reference_engine(g)
        for p, t in zip(scans, tickets):
            assert torch.equal(ref(p), t.result())
        svc.shutdown()
        assert not svc.serving
        st = svc.stats()
        assert st["served"] == len(scans) and st["queued"] == 0
        assert st["loop"]["passes"] >= 1 and st["loop"]["errors"] == 0
        svc.close()

    def test_shutdown_drains_queued_work_first(self, case16):
        g, scans = case16
        svc = service(max_batch=8)
        tickets = [svc.submit(projections=p, geometry=g) for p in scans]
        svc.serve()
        svc.shutdown()            # must serve the queue before exiting
        assert all(t.terminal for t in tickets)
        assert all(t.done for t in tickets)
        svc.close()

    def test_serve_is_idempotent_and_restartable(self, case16):
        g, scans = case16
        svc = service()
        svc.serve()
        first = svc._serve_thread
        svc.serve()                          # idempotent: same thread
        assert svc._serve_thread is first
        svc.shutdown()
        svc.serve()                          # restartable after shutdown
        t = svc.submit(projections=scans[0], geometry=g)
        assert t.wait(timeout=60.0)
        svc.shutdown()
        svc.close()

    def test_drain_while_serving_raises(self, case16):
        svc = service().serve()
        with pytest.raises(RuntimeError, match="serve"):
            svc.drain()
        svc.shutdown()
        svc.drain()                          # fine once the loop is down
        svc.close()

    def test_ticket_wait_and_result_timeout(self, case16):
        g, scans = case16
        svc = service()
        t = svc.submit(projections=scans[0], geometry=g)
        assert not t.wait(timeout=0.02)      # nothing serving yet
        with pytest.raises(RuntimeError, match="queued"):
            t.result(timeout=0.02)
        svc.serve()
        assert t.wait(timeout=60.0)
        t.result(timeout=60.0)
        svc.shutdown()
        svc.close()

    def test_loop_keeps_serving_after_a_failed_bucket(self, case16):
        g, scans = case16
        svc = service().serve()
        bad = svc.submit(source=ExplodingSource(), geometry=g)
        assert bad.wait(timeout=60.0)
        assert bad.state is TicketState.FAILED
        assert isinstance(bad.error, PrefetchError)
        good = svc.submit(projections=scans[0], geometry=g)
        assert good.wait(timeout=60.0)
        assert good.done
        assert svc.serving
        svc.shutdown()
        st = svc.stats()
        assert st["served"] == 1 and st["failed"] == 1
        assert st["loop"]["errors"] == 0     # bucket isolation, not a crash
        svc.close()

    def test_queue_full_backpressure_fires_under_loop(self, case16):
        g, scans = case16
        release = threading.Event()

        class SlowSource:
            def load(self, mesh=None, device="cuda"):
                release.wait(10.0)
                return torch.as_tensor(scans[0])

        svc = service(max_queue=2).serve()
        slow = svc.submit(source=SlowSource(), geometry=g)
        deadline = time.monotonic() + 5.0
        while ((svc.queued or slow.state is TicketState.QUEUED)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert slow.state is not TicketState.QUEUED
        queued = [svc.submit(projections=scans[1], geometry=g)
                  for _ in range(2)]            # fills max_queue=2
        with pytest.raises(QueueFullError):
            svc.submit(projections=scans[2], geometry=g)
        release.set()
        for t in [slow] + queued:
            assert t.wait(timeout=60.0)
        svc.shutdown()
        st = svc.stats()
        assert st["rejected"] >= 1
        assert st["submitted"] == st["served"] + st["failed"] == 3
        svc.close()

    def test_concurrent_submitters_race_the_loop(self, case16):
        g, scans = case16
        n_threads, per_thread = 4, 6
        svc = service(max_batch=4, max_queue=8).serve()
        tickets, rejected = [], []
        lock = threading.Lock()

        def submitter(tid):
            for k in range(per_thread):
                while True:
                    try:
                        t = svc.submit(projections=scans[k % len(scans)],
                                       geometry=g, scan_id=f"t{tid}-{k}")
                    except QueueFullError:
                        with lock:
                            rejected.append(1)
                        time.sleep(0.005)     # backpressure: retry
                        continue
                    with lock:
                        tickets.append(t)
                    break

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads)
        for t in tickets:
            assert t.wait(timeout=120.0), t.state
        svc.shutdown()
        assert len(tickets) == n_threads * per_thread
        assert len({t.scan_id for t in tickets}) == len(tickets)
        assert all(t.terminal for t in tickets)
        assert all(t.done and t.volume is not None for t in tickets)
        st = svc.stats()
        assert st["submitted"] == len(tickets)
        assert st["submitted"] == st["served"] + st["failed"]
        assert st["rejected"] == len(rejected)
        assert st["queued"] == 0
        ref = reference_engine(g)
        assert torch.equal(ref(scans[0]),
                           next(t for t in tickets
                                if t.scan_id == "t0-0").result())
        svc.close()


def _orders(make, g, scans, submit):
    """Execution order of `submit`'s scans, as positions in submission
    order, for a service from `make`."""
    svc = make()
    tickets = submit(svc, g, scans)
    ids = [t.scan_id for t in tickets]
    order = [ids.index(t.scan_id) for t in svc.drain()]
    svc.close()
    return order


def _lax_urgent(svc, g, scans):
    return [svc.submit(projections=scans[0], geometry=g, deadline_s=100.0),
            svc.submit(projections=scans[1], geometry=g, precision="bf16",
                       deadline_s=0.5)]


def _plain_slo(svc, g, scans):
    return [svc.submit(projections=scans[0], geometry=g),
            svc.submit(projections=scans[1], geometry=g, precision="bf16",
                       deadline_s=5.0)]


def _small_big(svc, g, scans):
    return ([svc.submit(projections=scans[0], geometry=g)]
            + [svc.submit(projections=p, geometry=g, precision="bf16")
               for p in scans[1:4]])


def _chatty_quiet(svc, g, scans):
    return ([svc.submit(projections=scans[k % len(scans)], geometry=g)
             for k in range(5)]
            + [svc.submit(projections=scans[0], geometry=g,
                          precision="bf16")])


class TestSchedulingPolicies:
    """Cross-family bucket ordering (`policy=`): drain() returns tickets
    in execution order, which is what these assertions read."""

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            service(policy="sjf")

    def test_deadline_policy_reorders_ahead_of_fifo(self, case16):
        g, scans = case16
        assert _orders(lambda: service(policy="deadline"), g, scans,
                       _lax_urgent) == [1, 0]
        assert _orders(lambda: service(policy="fifo"), g, scans,
                       _lax_urgent) == [0, 1]

    def test_deadline_less_buckets_run_last_in_arrival_order(self, case16):
        g, scans = case16
        assert _orders(lambda: service(policy="deadline"), g, scans,
                       _plain_slo) == [1, 0]

    def test_largest_bucket_policy_maximizes_occupancy_first(self, case16):
        g, scans = case16
        assert _orders(lambda: service(max_batch=4,
                                       policy="largest_bucket"),
                       g, scans, _small_big) == [1, 2, 3, 0]
        assert _orders(lambda: service(max_batch=4, policy="fifo"), g,
                       scans, _small_big) == [0, 1, 2, 3]

    def test_fifo_round_robin_is_fair_across_families(self, case16):
        """A chatty family (3 buckets queued) cannot starve a quiet one:
        the quiet family's bucket runs in round one."""
        g, scans = case16
        assert _orders(lambda: service(max_batch=2, policy="fifo"), g,
                       scans, _chatty_quiet) == [0, 1, 5, 2, 3, 4]

    @pytest.mark.parametrize("policy", ["fifo", "largest_bucket",
                                        "deadline"])
    @pytest.mark.parametrize("submit", [_lax_urgent, _plain_slo, _small_big,
                                        _chatty_quiet])
    def test_order_equals_the_jax_service(self, case16, policy, submit):
        g, scans = case16
        got = _orders(lambda: service(max_batch=2, policy=policy), g, scans,
                      submit)
        want = _orders(lambda: jservice.ReconstructionService(
            max_batch=2, policy=policy), JG, scans, submit)
        assert got == want


class TestSLO:
    def test_met_and_missed_counters(self, case16):
        g, scans = case16
        svc = service()
        met = svc.submit(projections=scans[0], geometry=g, deadline_s=60.0)
        missed = svc.submit(projections=scans[1], geometry=g,
                            deadline_s=0.0)   # already due at submit
        nolo = svc.submit(projections=scans[2], geometry=g)
        svc.drain()
        assert met.done and missed.done and nolo.done
        assert svc.stats()["slo"] == {"met": 1, "missed": 1,
                                      "attainment": 0.5}
        svc.close()

    def test_no_deadlines_means_no_attainment(self, case16):
        g, scans = case16
        svc = service()
        svc.submit(projections=scans[0], geometry=g)
        svc.drain()
        assert svc.stats()["slo"] == {"met": 0, "missed": 0,
                                      "attainment": None}
        svc.close()

    def test_failed_ticket_with_deadline_counts_missed(self, case16):
        g, _ = case16
        svc = service()
        t = svc.submit(source=ExplodingSource(), geometry=g,
                       deadline_s=60.0)
        svc.drain()
        assert t.state is TicketState.FAILED
        assert svc.stats()["slo"]["missed"] == 1
        svc.close()

    def test_negative_deadline_rejected(self, case16):
        from repro_torch.service import AdmissionError
        g, scans = case16
        svc = service()
        with pytest.raises(AdmissionError, match="deadline_s"):
            svc.submit(projections=scans[0], geometry=g, deadline_s=-1.0)
        assert svc.stats()["rejected"] == 1
        svc.close()

    def test_ticket_deadline_is_absolute(self, case16):
        g, scans = case16
        svc = service()
        t = svc.submit(projections=scans[0], geometry=g, deadline_s=30.0)
        assert t.deadline == pytest.approx(t.submitted_at + 30.0)
        plain = svc.submit(projections=scans[1], geometry=g)
        assert plain.deadline is None
        svc.close()
