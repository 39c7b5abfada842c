"""The serving path traced from inside the port, on the CPU: the tracer's
device stages and counts (`obs.trace.device_stage`, `device_count`), its
async events and clock, the batched engine's stage times, and
`ReconstructionService`'s own spans, args, scan events and arrival times,
at a 16^3 volume. On the CPU a device stage is two host stamps (the work is
synchronous), so these tests run the same resolution code the card does.
Imports neither JAX nor the JAX package.
"""
import json
import threading
import time

import pytest
import torch

from repro_torch.core import plan as tplan
from repro_torch.core.geometry import default_geometry
from repro_torch.core.phantom import forward_project
from repro_torch.obs import metrics, trace
from repro_torch.service import ReconstructionService, TicketState
from repro_torch.service import scheduler as tsched

torch.set_num_threads(1)

G = default_geometry(16, n_proj=8)
SPEC = "impl=kernel,precision=fp32,schedule=fused,window=ramlak,reduce=psum"
LANE_STAGES = ["bp.kernel", "bp.operands", "bp.unfold", "stage.backproject",
               "stage.filter", "stage.reduce"]


@pytest.fixture
def tracer():
    """A fresh enabled process tracer, the previous one restored after."""
    tr = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


@pytest.fixture(scope="module")
def scans():
    base = forward_project(G, device="cpu")
    return [base * (1.0 + 0.25 * k) for k in range(3)]


def busy(seconds=0.002):
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        pass


# -- device stages and counts ------------------------------------------------

def test_device_stage_off_is_the_shared_no_op():
    prev = trace.set_tracer(trace.Tracer(enabled=False))
    try:
        assert trace.device_stage("stage.filter") is trace._NULL_SPAN
        trace.device_count("direct_pairs", 5, "test.trace.off")
    finally:
        trace.set_tracer(prev)
    assert metrics.default_registry().value("test.trace.off") == 0


def test_device_stage_outside_any_span_is_not_kept(tracer):
    assert trace.device_stage("stage.filter") is trace._NULL_SPAN
    trace.device_count("tile_pairs", 3)
    assert tracer._thread.pending == []


def test_device_stages_resolve_at_the_innermost_fence_only(tracer):
    reg = metrics.default_registry()
    before = reg.value("test.trace.direct")
    with tracer.span("outer") as outer:
        with trace.device_stage("stage.allgather"):
            busy()
        with tracer.span("inner") as inner:
            with trace.device_stage("stage.filter", "cpu"):
                busy()
            with trace.device_stage("stage.filter"):
                busy()
            trace.device_count("direct_pairs", torch.tensor([4]),
                               "test.trace.direct")
            trace.device_count("direct_pairs", 3, "test.trace.direct")
            trace.device_count("tile_pairs", 10)
            # nothing is resolved before the fence
            assert "device_ms" not in inner.args
            assert reg.value("test.trace.direct") == before
            assert len(tracer._thread.pending) == 6
            inner.fence(None)
        with tracer.span("unfenced"):
            with trace.device_stage("stage.reduce"):
                busy()
        assert len(tracer._thread.pending) == 2
        outer.fence(None)
    assert tracer._thread.pending == []
    assert sorted(inner.args["device_ms"]) == ["stage.filter"]
    assert inner.args["device_ms"]["stage.filter"] >= 4.0
    assert (inner.args["direct_pairs"], inner.args["tile_pairs"]) == (7, 10)
    assert reg.value("test.trace.direct") == before + 7
    assert sorted(outer.args["device_ms"]) == ["stage.allgather",
                                               "stage.reduce"]
    assert "direct_pairs" not in outer.args
    by_name = {e["name"]: e for e in tracer.events()}
    assert by_name["inner"]["args"]["device_ms"] == inner.args["device_ms"]
    assert "device_ms" not in by_name["unfenced"].get("args", {})


def test_pending_stages_are_dropped_when_the_outermost_span_closes(tracer):
    with tracer.span("never.fenced"):
        with trace.device_stage("stage.filter"):
            pass
        assert len(tracer._thread.pending) == 1
    assert tracer._thread.pending == [] and tracer._thread.depth == 0


def test_device_stages_are_per_thread(tracer):
    got = {}

    def other():
        with tracer.span("other") as sp:
            with trace.device_stage("stage.reduce"):
                busy()
            sp.fence(None)
        got.update(sp.args["device_ms"])
    with tracer.span("main") as sp:
        with trace.device_stage("stage.filter"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
        sp.fence(None)
    assert sorted(got) == ["stage.reduce"]
    assert sorted(sp.args["device_ms"]) == ["stage.filter"]


def test_async_pairs_and_the_exported_clock(tracer, tmp_path):
    t0 = time.perf_counter_ns()
    tracer.async_pair("scan", "scan-7", t0 - 1_000_000, t0, state="done")
    b, e = tracer.events()
    assert (b["ph"], e["ph"]) == ("b", "e")
    assert b["id"] == e["id"] == "scan-7" and b["cat"] == e["cat"] == "scan"
    assert e["ts"] - b["ts"] == pytest.approx(1000.0)
    assert b["args"] == {"state": "done"} and "args" not in e
    other = json.loads(open(tracer.save(str(tmp_path / "t.json"))).read())
    assert other["otherData"]["clock"] == "perf_counter_ns"
    # the epoch is a perf_counter_ns reading: ts 0 is that instant
    assert abs(other["otherData"]["epoch_ns"] + b["ts"] * 1e3
               - (t0 - 1_000_000)) < 1e3
    off = trace.Tracer(enabled=False)
    off.async_pair("scan", "x", 0, 1)
    assert off.events() == []


# -- the batched engine's stage times ----------------------------------------

def test_batched_engine_carries_its_lanes_stage_times(tracer, scans):
    plan = tplan.plan_from_spec(G, SPEC, device="cpu")
    engine = plan.build_batched(2)
    want = [plan.build()(s) for s in scans[:2]]
    tracer.clear()
    out = engine(torch.stack(scans[:2]))
    (ev,) = tracer.spans("engine.batched")
    args = ev["args"]
    assert args["lanes"] == args["batch"] == 2
    assert sorted(args["device_ms"]) == LANE_STAGES
    ms = args["device_ms"]
    assert ms["bp.operands"] + ms["bp.kernel"] + ms["bp.unfold"] \
        <= ms["stage.backproject"] <= ev["dur"] / 1e3
    # on the CPU the plain version runs: no launch, no direct count
    assert "direct_pairs" not in args and "tile_pairs" not in args
    for b in range(2):   # the lanes' contract holds with the stages timed
        assert torch.equal(out[b], want[b])


# -- the service -------------------------------------------------------------

def test_serve_loop_spans_args_and_scan_events(tracer, scans):
    svc = ReconstructionService(device="cpu", spec=SPEC, max_batch=4)
    tracer.clear()
    svc.serve()
    try:
        time.sleep(0.3)          # the loop waits: service.loop.wait spans
        host = [s.numpy() for s in scans]   # not tensors on the device
        tickets = [svc.submit(projections=p, geometry=G) for p in host]
        for t in tickets:
            assert t.wait(timeout=120) and t.done
        svc.shutdown()
    finally:
        svc.close()
    names = {e["name"] for e in tracer.spans()}
    assert {"service.loop.wait", "service.schedule", "service.drain",
            "service.bucket", "service.bucket.assemble", "service.lane.get",
            "service.lane.h2d", "engine.batched"} <= names
    buckets = tracer.spans("service.bucket")
    buckets = [b for b in buckets if b["name"] == "service.bucket"]
    ids = [i for b in buckets for i in b["args"]["scan_ids"]]
    assert sorted(ids) == sorted(t.scan_id for t in tickets)
    for b in buckets:
        a = b["args"]
        assert "pads" not in a and "batch" not in a
        assert len(a["queue_ms"]) == a["scans"] == len(a["scan_ids"])
        assert all(q >= 0 for q in a["queue_ms"])
        # no device work of the bucket's own: its lanes go to the engine
        # as they are
        assert "device_ms" not in a
    h2d = tracer.spans("service.lane.h2d")
    assert sorted(e["args"]["scan_id"] for e in h2d) == sorted(ids)
    lane_bytes = G.n_proj * G.n_v * G.n_u * 4
    assert all(e["args"]["bytes"] == lane_bytes and e["args"]["src"] == "host"
               and e["args"]["pinned"] is False for e in h2d)
    lanes = sum(e["args"]["lanes"] for e in tracer.spans("engine.batched"))
    assert lanes == sum(b["args"]["scans"] for b in buckets) == len(tickets)
    pairs = {}
    for e in tracer.events():
        if e.get("cat") == "scan":
            pairs.setdefault(e["id"], []).append(e)
    assert sorted(pairs) == sorted(ids)
    for t in tickets:
        b, e = pairs[t.scan_id]
        assert (b["ph"], e["ph"]) == ("b", "e")
        assert b["args"]["state"] == "done" and e["ts"] >= b["ts"]
        # arrival to DONE covers the scan's bucket
        bucket = next(x for x in buckets if t.scan_id in x["args"]["scan_ids"])
        assert b["ts"] <= bucket["ts"] and e["ts"] <= bucket["ts"] \
            + bucket["dur"]


def test_a_lane_already_on_the_device_copies_nothing(tracer, scans):
    svc = ReconstructionService(device="cpu", spec=SPEC, max_batch=2)
    try:
        t = svc.submit(projections=scans[0], geometry=G, scan_id="on-card")
        svc.drain()
    finally:
        svc.close()
    assert t.done
    (h2d,) = tracer.spans("service.lane.h2d")
    assert h2d["args"] == {"bytes": 0, "src": "device", "pinned": False,
                           "scan_id": "on-card"}


def test_failed_scans_end_their_async_pair(tracer, scans):
    class Broken:
        def load(self, mesh=None, device="cuda"):
            raise IOError("bad shard")
    svc = ReconstructionService(device="cpu", spec=SPEC, max_batch=2)
    try:
        t = svc.submit(source=Broken(), geometry=G, scan_id="broken")
        svc.drain()
    finally:
        svc.close()
    assert t.state is TicketState.FAILED
    b, e = [x for x in tracer.events() if x.get("cat") == "scan"]
    assert b["id"] == "broken" and b["args"]["state"] == "failed"


def test_arrived_at_defaults_to_submit_and_moves_the_latencies(scans):
    svc = ReconstructionService(device="cpu", spec=SPEC, max_batch=1)
    try:
        now = svc.submit(projections=scans[0], geometry=G, deadline_s=30.0)
        assert now.arrived_at == now.submitted_at == now.start
        assert now.deadline == now.submitted_at + 30.0
        early = time.perf_counter() - 5.0
        late = svc.submit(projections=scans[0], geometry=G, deadline_s=30.0,
                          arrived_at=early)
        assert late.arrived_at == early < late.submitted_at
        assert late.deadline == early + 30.0
        svc.drain()
        assert now.done and late.done
        st = svc.stats()["latency"]
        # the earlier arrival waited >= 5 s in the queue, and its volume
        # took >= 5 s; the scan submitted as it arrived took far less
        assert st["queue_wait"]["max"] >= 5.0 > st["queue_wait"]["min"]
        assert st["time_to_volume"]["max"] >= 5.0 \
            > st["time_to_volume"]["min"]
        with pytest.raises(ValueError, match="arrived_at"):
            svc.submit(projections=scans[0], geometry=G,
                       arrived_at=time.perf_counter() + 60.0)
        assert svc.stats()["rejected"] == 1
    finally:
        svc.close()


def test_a_traced_bucket_waits_no_more_than_before(tracer, scans,
                                                   monkeypatch):
    """Three waits a traced bucket, as before the device stages: the
    engine's fence, the bucket's fence and its wait for the volumes."""
    calls = []
    real = trace.wait_for

    def counting(value):
        calls.append(value)
        real(value)
    monkeypatch.setattr(trace, "wait_for", counting)
    monkeypatch.setattr(tsched, "wait_for", counting)
    svc = ReconstructionService(device="cpu", spec=SPEC, max_batch=2)
    try:
        for s in scans:
            svc.submit(projections=s, geometry=G)
        svc.drain()
        n_buckets = svc.stats()["buckets"]
    finally:
        svc.close()
    assert n_buckets == 2 and len(calls) == 3 * n_buckets
