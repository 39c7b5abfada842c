"""Streamed scans served by `ReconstructionService` (`open_stream`,
`push`), on the CPU: volumes against the benchmark's plain float64
reference (bench/reference/fdk.py) within the stream cell's limits and
against the fused plan; interleaved streams with their deltas out of
order; every rejection path; the memory budget and queue bounds; a fold
that fails; close() with a stream open; the time to volume from the last
delta; and the stream's spans, counters and async events. At the
benchmark's test sizes (32 projections of 24 x 20 into 16^3, 8 deltas of
4). Imports neither JAX nor the JAX package.
"""
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import fdk, phantom  # noqa: E402
from bench.reference.geometry import Geometry  # noqa: E402
from repro_torch.core.geometry import CBCTGeometry  # noqa: E402
from repro_torch.core.plan import ReconstructionPlan  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.service import (  # noqa: E402
    AdmissionError, QueueFullError, ReconstructionService, TicketState)

torch.set_num_threads(1)

CONFIG = json.loads(
    (ROOT / "bench/configs/rabbitct-512-stream.json").read_text())
SPEC = CONFIG["plan"]
LIMITS = CONFIG["limits"]
REF_G = Geometry.from_dict(dict(
    CONFIG["geometry"], n_proj=32, n_u=24, n_v=20, d_u=4.8 / 24,
    d_v=4.8 / 24, n_x=16, n_y=16, n_z=16, d_x=2 / 16, d_y=2 / 16,
    d_z=2 / 16))
G = CBCTGeometry(**REF_G.as_dict())
STEP = G.n_proj // 8
SLICES = [(lo, lo + STEP) for lo in range(0, G.n_proj, STEP)]
SEED = 2**31 + 41


@pytest.fixture(scope="module")
def scans():
    """Three seeded phantoms' projections."""
    return [phantom.project(REF_G, phantom.ellipsoids(SEED, k))
            for k in range(3)]


@pytest.fixture(scope="module")
def refs(scans):
    return [fdk.reconstruct(REF_G, p) for p in scans]


@pytest.fixture
def tracer():
    tr = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


def service(**kw):
    return ReconstructionService(device="cpu", spec=SPEC, **kw)


def stream_in(svc, ticket, proj, order=None, **kw):
    for lo, hi in (SLICES if order is None else [SLICES[i] for i in order]):
        svc.push(ticket, proj[lo:hi], (lo, hi), **kw)


def gaps(vol, ref):
    d = vol.double() - ref
    return {"rel_rmse": float(d.norm() / ref.norm()),
            "max_rel_err": float(d.abs().max() / ref.abs().max())}


@pytest.mark.parametrize("k", [0, 1])
def test_served_stream_matches_the_plain_reference(scans, refs, k):
    svc = service().serve()
    try:
        ticket = svc.open_stream(geometry=G)
        stream_in(svc, ticket, scans[k])
        assert ticket.wait(timeout=60) and ticket.done, ticket.error
        got = gaps(ticket.result(), refs[k])
    finally:
        svc.close()
    assert all(got[n] <= LIMITS[n] for n in LIMITS), got
    st = svc.stats()
    assert st["served"] == 1 and st["failed"] == 0
    assert st["streams"] == {"open": 0, "opened": 1, "deltas": 8,
                             "resident_bytes": 0}


def test_interleaved_streams_out_of_order_match_fused_and_reference(
        scans, refs):
    """Three streams, each with its deltas in its own seeded order, their
    pushes interleaved while the serve loop folds."""
    rng = np.random.default_rng(SEED)
    orders = [rng.permutation(len(SLICES)) for _ in scans]
    assert not all((o == np.arange(len(SLICES))).all() for o in orders)
    svc = service().serve()
    try:
        tickets = [svc.open_stream(geometry=G) for _ in scans]
        for j in range(len(SLICES)):
            for t, proj, order in zip(tickets, scans, orders):
                lo, hi = SLICES[order[j]]
                svc.push(t, proj[lo:hi], (lo, hi))
        for t in tickets:
            assert t.wait(timeout=60) and t.done, t.error
    finally:
        svc.close()
    fused = ReconstructionPlan(geometry=G, impl="kernel", device="cpu",
                               precision="fp32").build()
    for t, proj, ref in zip(tickets, scans, refs):
        vol = t.result()
        want = fused(proj)
        assert float((vol - want).abs().max() / want.abs().max()) <= 1e-5
        got = gaps(vol, ref)
        assert all(got[n] <= LIMITS[n] for n in LIMITS), got


def test_every_rejection_path_raises_at_push_and_counts(scans):
    proj = scans[0]
    svc = service()
    other = service()
    try:
        t = svc.open_stream(geometry=G)
        svc.push(t, proj[0:4], (0, 4))
        with pytest.raises(AdmissionError, match="overlaps"):
            svc.push(t, proj[2:6], (2, 6))
        with pytest.raises(AdmissionError, match="out of range"):
            svc.push(t, proj[28:32], (28, 36))
        with pytest.raises(AdmissionError, match="shape"):
            svc.push(t, proj[4:7], (4, 8))
        with pytest.raises(AdmissionError, match="not open"):
            other.push(t, proj[4:8], (4, 8))
        for lo, hi in SLICES[1:]:
            svc.push(t, proj[lo:hi], (lo, hi))
        svc.drain()
        assert t.done
        with pytest.raises(AdmissionError, match="not open"):
            svc.push(t, proj[0:4], (0, 4))
        with pytest.raises(AdmissionError, match="arrived_at"):
            svc.push(t, proj[0:4], (0, 4),
                     arrived_at=time.perf_counter() + 10)
        with pytest.raises(AdmissionError, match="schedule='fused'"):
            svc.open_stream(geometry=G, schedule="fused", n_steps=1)
        with pytest.raises(AdmissionError, match="open_stream"):
            svc.submit(projections=proj, geometry=G)
        assert svc.stats()["rejected"] == 7
        assert other.stats()["rejected"] == 1
        assert svc.stats()["served"] == 1
    finally:
        svc.close()
        other.close()


def test_queue_bounds_refuse_streams_and_deltas(scans):
    proj = scans[0]
    svc = service(max_queue=2)
    try:
        a = svc.open_stream(geometry=G, scan_id="a")
        with pytest.raises(AdmissionError, match="open already"):
            svc.open_stream(geometry=G, scan_id="a")
        svc.open_stream(geometry=G)
        with pytest.raises(QueueFullError):
            svc.open_stream(geometry=G)
        svc.push(a, proj[0:4], (0, 4))
        svc.push(a, proj[4:8], (4, 8))
        with pytest.raises(QueueFullError):
            svc.push(a, proj[8:12], (8, 12))
        svc.drain()
        svc.push(a, proj[8:12], (8, 12))
        assert svc.stats()["rejected"] == 3
    finally:
        svc.close()


def test_budget_refuses_a_stream_next_to_the_open_ones(scans):
    from repro_torch.core.plan import plan_from_spec
    from repro_torch.planner import plan_footprint, point_from_plan
    from repro_torch.planner.feasibility import session_resident_bytes
    point = point_from_plan(plan_from_spec(G, SPEC, device="cpu"))
    total = plan_footprint(G, point).total
    resident = session_resident_bytes(G, point)
    assert resident == G.n_x * G.n_y * G.n_z * 4 and resident < total
    svc = service(hbm_bytes=total + resident // 2)
    try:
        t = svc.open_stream(geometry=G)
        assert svc.stats()["streams"]["resident_bytes"] == resident
        with pytest.raises(AdmissionError, match="next to 1 open streams"):
            svc.open_stream(geometry=G)
        stream_in(svc, t, scans[0])
        svc.drain()
        assert t.done and svc.stats()["streams"]["resident_bytes"] == 0
        svc.open_stream(geometry=G)       # fits again once t is done
        assert svc.stats()["rejected"] == 1
    finally:
        svc.close()


WHOLE = {"schedule": "fused", "n_steps": 1}


def footprints():
    """(a whole scan's footprint under the WHOLE pins, a stream's, the
    stream's resident accumulator), bytes on the CPU service."""
    from repro_torch.planner import plan_footprint, point_from_plan
    from repro_torch.planner.feasibility import session_resident_bytes
    from repro_torch.service.requests import ScanFamily
    svc = service()
    whole, stream = (
        point_from_plan(svc.plan_cache.resolve(ScanFamily.make(G, None, p)))
        for p in (WHOLE, {}))
    return (plan_footprint(G, whole).total, plan_footprint(G, stream).total,
            session_resident_bytes(G, stream))


def test_open_streams_shrink_buckets_and_refuse_a_whole_scan(scans):
    whole, stream, resident = footprints()
    assert stream <= 2 * whole
    svc = service(max_batch=2, hbm_bytes=2 * whole + resident // 2)
    try:
        for k in range(2):
            svc.submit(projections=scans[k], geometry=G, **WHOLE)
        svc.drain()
        assert svc.stats()["buckets"] == 1      # one bucket of two
        t = svc.open_stream(geometry=G)
        pair = [svc.submit(projections=scans[k], geometry=G, **WHOLE)
                for k in range(2)]
        svc.drain()
        assert all(x.done for x in pair)
        assert svc.stats()["buckets"] == 3      # two of one beside t
        stream_in(svc, t, scans[2])
        svc.drain()
        assert t.done
    finally:
        svc.close()
    assert stream <= whole
    svc = service(hbm_bytes=whole + resident // 2)
    try:
        svc.open_stream(geometry=G)
        with pytest.raises(AdmissionError, match="held by open streams"):
            svc.submit(projections=scans[0], geometry=G, **WHOLE)
        assert svc.stats()["rejected"] == 1
    finally:
        svc.close()


class _OpensAStream:
    """A projection source whose load, made while its bucket is being
    served, opens a stream on the service and keeps what it raised."""

    def __init__(self, svc, proj):
        self.svc, self.proj, self.error = svc, proj, None

    def load(self, mesh, device="cpu"):
        try:
            self.svc.open_stream(geometry=G)
        except AdmissionError as e:
            self.error = e
        return self.proj


def test_a_stream_is_priced_next_to_the_bucket_being_served(scans):
    whole, stream, _ = footprints()
    svc = service(hbm_bytes=whole + stream - 1)
    try:
        src = _OpensAStream(svc, scans[0])
        t = svc.submit(source=src, geometry=G, **WHOLE)
        svc.drain()
        assert t.done
        assert "a bucket's" in str(src.error)
        svc.open_stream(geometry=G)         # fits once the pass is over
        assert svc.stats()["streams"]["open"] == 1
    finally:
        svc.close()


def test_a_fold_that_raises_fails_only_its_stream(scans):
    svc = service().serve()
    try:
        bad, good = (svc.open_stream(geometry=G) for _ in range(2))
        session = svc._streams[bad.scan_id].session

        def broken(*args, **kwargs):
            raise RuntimeError("fold exploded")
        session.update = broken
        stream_in(svc, bad, scans[0])
        stream_in(svc, good, scans[1])
        assert good.wait(timeout=60) and good.done
        assert bad.wait(timeout=60) and bad.state is TicketState.FAILED
        assert "exploded" in str(bad.error)
        st = svc.stats()
        assert (st["served"], st["failed"], st["loop"]["errors"]) == (1, 1, 0)
        assert st["streams"]["open"] == 0
    finally:
        svc.close()


def test_close_fails_a_stream_still_open(scans):
    svc = service().serve()
    t = svc.open_stream(geometry=G, deadline_s=60.0)
    stream_in(svc, t, scans[0], order=range(3))
    svc.close()
    assert t.state is TicketState.FAILED and "closed" in str(t.error)
    st = svc.stats()
    assert st["failed"] == 1 and st["slo"]["missed"] == 1
    assert st["streams"]["deltas"] == 3 and st["streams"]["open"] == 0
    with pytest.raises(AdmissionError, match="not open"):
        svc.push(t, scans[0][12:16], (12, 16))


def test_time_to_volume_counts_from_the_last_delta(scans):
    svc = service().serve()
    try:
        t = svc.open_stream(geometry=G, deadline_s=30.0)
        stream_in(svc, t, scans[0], order=range(7))
        time.sleep(0.3)            # the rest of the spin, before its end
        last = time.perf_counter()
        lo, hi = SLICES[7]
        svc.push(t, scans[0][lo:hi], (lo, hi), arrived_at=last)
        assert t.wait(timeout=60) and t.done
        t_seen = time.perf_counter()
        assert t.arrived_at == last and t.submitted_at < last - 0.3
        ttv = svc.stats()["latency"]["time_to_volume"]
        assert ttv["count"] == 1
        assert 0 < ttv["sum"] <= t_seen - last < 0.3
        assert svc.stats()["slo"]["met"] == 1
    finally:
        svc.close()


def test_stream_spans_counters_and_async_events(scans, tracer):
    svc = service()
    try:
        t = svc.open_stream(geometry=G, scan_id="room3-spin1")
        t_open = time.perf_counter_ns()
        stream_in(svc, t, scans[0], order=[1, 0, 2, 3, 4, 5, 7, 6])
        served = svc.drain()
    finally:
        svc.close()
    assert served == [t] and t.done
    folds = tracer.spans("service.stream.fold")
    assert [(e["args"]["lo"], e["args"]["final"]) for e in folds] == [
        (4, False), (0, False), (8, False), (12, False), (16, False),
        (20, False), (28, False), (24, True)]
    inner = tracer.spans("session.fold")
    assert len(inner) == len(folds)
    for e, f in zip(folds, inner):
        args = e["args"]
        assert args["scan_id"] == "room3-spin1"
        assert args["hi"] == args["lo"] + STEP and args["wait_ms"] >= 0
        assert "device_ms" not in args    # the session's span fences
        assert (f["args"]["lo"], f["args"]["final"]) == (args["lo"],
                                                         args["final"])
        assert e["ts"] <= f["ts"] and f["dur"] <= e["dur"]
        stages = set(f["args"]["device_ms"])
        assert {"stage.filter", "stage.backproject",
                "stream.accumulate"} <= stages
        assert ("stream.finalize" in stages) == args["final"]
        assert f["args"]["dispatch_us"] <= f["dur"]
    (b,) = [e for e in tracer.events() if e["ph"] == "b"]
    (e_,) = [e for e in tracer.events() if e["ph"] == "e"]
    assert b["id"] == e_["id"] == "room3-spin1" and b["cat"] == "scan"
    assert b["args"]["state"] == "done"
    epoch = tracer._epoch_ns
    assert b["ts"] <= (t_open - epoch) / 1e3 < e_["ts"]
    assert e_["ts"] - b["ts"] >= folds[-1]["dur"]
    m = svc.metrics
    assert m.value("service.streams.opened", 0) == 1
    assert m.value("service.stream.deltas", 0) == 8


def test_buckets_and_streams_share_one_serve_loop(scans):
    """A whole scan under a fused pin and a stream on one service: the
    loop folds the stream's deltas and serves the bucket, from pushes and
    a submit made from two threads."""
    svc = service().serve()
    try:
        t = svc.open_stream(geometry=G)
        pusher = threading.Thread(target=stream_in, args=(svc, t, scans[0]))
        pusher.start()
        whole = svc.submit(projections=scans[1], geometry=G,
                           schedule="fused", n_steps=1)
        pusher.join()
        assert t.wait(timeout=60) and t.done
        assert whole.wait(timeout=60) and whole.done
        fused = svc.plan_cache.resolve(whole.family).build()
        assert torch.equal(whole.result(), fused(scans[1]))
        st = svc.stats()
        assert (st["served"], st["buckets"], st["loop"]["errors"]) == (
            2, 1, 0)
    finally:
        svc.close()


def test_the_serve_loop_polls_while_a_stream_is_open(scans, tracer):
    """The loop polls for work while a stream is open: it folds every
    pushed delta and goes back to sleeping once the stream has ended."""
    svc = service().serve()
    try:
        warm = svc.open_stream(geometry=G)
        stream_in(svc, warm, scans[1])
        assert warm.wait(timeout=60) and warm.done
        t = svc.open_stream(geometry=G)
        for lo, hi in SLICES:
            time.sleep(0.02)
            svc.push(t, scans[0][lo:hi], (lo, hi))
        assert t.wait(timeout=60) and t.done
        time.sleep(0.05)
    finally:
        svc.close()
    names = [e["name"] for e in tracer.spans("service.loop")]
    assert names.count("service.loop.poll") >= 4
    assert names[-1] == "service.loop.wait"
    assert len(tracer.spans("service.stream.fold")) == 16
    assert svc.stats()["loop"]["errors"] == 0
