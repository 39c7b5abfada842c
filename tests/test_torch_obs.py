"""Port parity for observability: `repro_torch.obs` (tracer, metrics
registry) and the engine cache's registry mirror, against `repro.obs`.

The same sequence of instrument calls goes to both packages' registries
and gives equal snapshots and renders; the same nested spans give the same
events, prefix views and stage totals; exports have the same keys; a named
`CountingLRU` counts into the registry as the reference's does. The port's
own fencing (CUDA events; nothing to wait for on the CPU) and the
engine span of `build()` are checked here too.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import plan as jplan
from repro.core.geometry import default_geometry as jdefault_geometry
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.core import cache as tcache
from repro_torch.core import plan as tplan
from repro_torch.core.geometry import default_geometry
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

torch.set_num_threads(1)

PACKAGES = {"jax": (jmetrics, jtrace, jcache),
            "torch": (tmetrics, ttrace, tcache)}


def drive_registry(metrics):
    """One fixed sequence of counter/gauge/histogram calls."""
    reg = metrics.MetricsRegistry()
    reg.counter("svc.scans.served").inc()
    reg.counter("svc.scans.served").inc(4)
    g = reg.gauge("io.queue_depth")
    g.set(3)
    g.inc(2.5)
    g.dec(4)
    h = reg.histogram("svc.time_seconds")
    for v in (1e-5, 1e-4, 0.003, 0.5, 2.0, 1e4):
        h.observe(v)
    custom = reg.histogram("io.bytes", buckets=(1, 2, 4))
    for v in (0.5, 1.0, 3.0, 100.0):
        custom.observe(v)
    reg.histogram("empty_seconds")
    return reg


def test_registry_snapshots_and_renders_match():
    j, t = (drive_registry(m) for m in (jmetrics, tmetrics))
    assert t.snapshot() == j.snapshot()
    assert t.render() == j.render()
    assert t.names() == j.names()
    assert t.value("svc.scans.served") == j.value("svc.scans.served") == 5
    assert t.value("missing", default=None) is None
    assert tmetrics.DEFAULT_TIME_BUCKETS == jmetrics.DEFAULT_TIME_BUCKETS


@pytest.mark.parametrize("edges", [(), (1.0, float("inf")), (2.0, 1.0),
                                   (1.0, 1.0)],
                         ids=["empty", "inf", "decreasing", "repeated"])
def test_histogram_edge_errors_match(edges):
    msgs = []
    for metrics in (jmetrics, tmetrics):
        with pytest.raises(ValueError) as e:
            metrics.Histogram("h", edges)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_registry_collisions_match():
    msgs = []
    for metrics in (jmetrics, tmetrics):
        reg = metrics.MetricsRegistry()
        reg.counter("a")
        reg.histogram("h", buckets=(1, 2))
        with pytest.raises(TypeError) as e1:
            reg.gauge("a")
        with pytest.raises(ValueError) as e2:
            reg.histogram("h", buckets=(1, 3))
        with pytest.raises(ValueError) as e3:
            reg.counter("c").inc(-1)
        msgs.append((str(e1.value), str(e2.value), str(e3.value)))
    assert msgs[0] == msgs[1]


def record_spans(trace):
    """Nested spans, an instant, an error span and a timed span on a fresh
    enabled tracer; returns it."""
    tr = trace.Tracer(enabled=True)
    with tr.span("stage.read", path="a") as outer:
        with tr.span("stage.filter", n=2):
            time.sleep(0.001)
        outer.set(extra="v")
        tr.instant("marker", k=1)
    with tr.span("stage.filter", n=3):
        pass
    with pytest.raises(ValueError):
        with tr.span("engine.fail"):
            raise ValueError("boom")
    with tr.span("engine.fenced") as sp:
        sp.fence(None)
    return tr


def test_spans_nesting_prefix_and_stage_totals_match():
    j, t = (record_spans(tr) for tr in (jtrace, ttrace))

    def shape(tr):
        return [(e["ph"], e["name"], sorted(e.get("args", {})))
                for e in tr.events()]
    assert shape(t) == shape(j)
    assert [e["name"] for e in t.spans("stage.")] == \
        [e["name"] for e in j.spans("stage.")] == \
        ["stage.filter", "stage.read", "stage.filter"]
    outer, inner = (next(e for e in t.spans(n)) for n in ("stage.read",
                                                          "stage.filter"))
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["tid"] == outer["tid"] == threading.get_ident()
    assert sorted(t.stage_totals()) == sorted(j.stage_totals())
    assert t.stage_totals()["stage.filter"] >= 0.001
    fail = next(e for e in t.events() if e["name"] == "engine.fail")
    assert fail["args"] == {"error": "ValueError"}
    fenced = next(e for e in t.events() if e["name"] == "engine.fenced")
    assert 0 <= fenced["args"]["dispatch_us"] <= fenced["dur"]


def test_export_has_the_reference_keys(tmp_path):
    j, t = (record_spans(tr) for tr in (jtrace, ttrace))
    je, te = j.export(), t.export()
    assert set(te) == set(je)
    assert te["otherData"] == je["otherData"] == {"dropped": 0}
    for a, b in zip(te["traceEvents"], je["traceEvents"]):
        assert set(a) == set(b)
    path = t.save(str(tmp_path / "trace.json"))
    assert json.loads(open(path).read()) == te


def test_disabled_and_timed_spans():
    for trace in (jtrace, ttrace):
        tr = trace.Tracer(enabled=False)
        assert tr.span("a") is tr.span("b")
        with tr.span("a") as sp:
            assert sp.fence(123) == 123
        with tr.span("t", timed=True) as timed:
            time.sleep(0.002)
        assert timed.duration_s >= 0.002 and tr.events() == []


def test_max_events_and_threads():
    tr = ttrace.Tracer(enabled=True, max_events=10)
    for i in range(15):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 10 and tr.dropped == 5
    tr.clear()
    tr.max_events = 10_000

    # all eight alive at once, so their idents are distinct
    together = threading.Barrier(8, timeout=30)

    def work():
        together.wait()
        for _ in range(50):
            with tr.span("thread.work"):
                pass
        together.wait()
    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    evs = tr.spans("thread.")
    assert len(evs) == 400 and len({e["tid"] for e in evs}) == 8


def test_fence_walks_containers_on_the_cpu():
    """CPU tensors, None and nested containers: nothing to wait for, and
    the value comes back as it was."""
    value = (torch.ones(2), None, [torch.zeros(1), {"k": torch.ones(1)}], 3)
    tr = ttrace.Tracer(enabled=True)
    with tr.span("f") as sp:
        assert sp.fence(value) is value
    assert sp.dispatch_s is not None and sp.dispatch_s <= sp.duration_s
    assert ttrace._cuda_devices(value, set()) == set()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_named_counting_lru_mirrors_into_the_registry(pkg):
    metrics, _, cache = PACKAGES[pkg]
    reg = metrics.default_registry()
    names = [f"cache.torch_obs_lru.{c}"
             for c in ("hits", "misses", "evictions", "unhashable")]
    before = [reg.value(n) for n in names]
    lru = cache.CountingLRU(capacity=1, name="torch_obs_lru")
    lru.put("a", 1)
    lru.put("b", 2)            # evicts "a"
    lru.get("b")
    lru.get("zz")
    lru.get(["unhashable"])
    lru.clear(reset_counters=True)   # the registry keeps counting
    assert [reg.value(n) - b for n, b in zip(names, before)] == [1, 1, 1, 1]
    assert lru.stats()["hits"] == 0
    assert cache.CountingLRU(capacity=1).name is None


def test_engine_cache_counts_into_the_default_registry():
    reg = tmetrics.default_registry()
    g = default_geometry(8, n_proj=4)
    plan = tplan.ReconstructionPlan(geometry=g, device="cpu")
    tplan.clear_engine_cache()
    hits = reg.value("cache.core.engine_cache.hits")
    misses = reg.value("cache.core.engine_cache.misses")
    plan.build()
    plan.build()
    assert reg.value("cache.core.engine_cache.hits") - hits == 1
    assert reg.value("cache.core.engine_cache.misses") - misses == 1
    assert "cache.core.engine_cache.hits" in tobs.default_registry().snapshot()
    assert jplan._ENGINE_CACHE.name == tplan._ENGINE_CACHE.name


def test_engine_span_matches_the_reference():
    """build()'s engine runs in an `engine.reconstruct` span with the
    reference's attributes and a dispatch time, only while the tracer is
    on."""
    g, tg = jdefault_geometry(8, n_proj=4), default_geometry(8, n_proj=4)
    proj = np.zeros(g.proj_shape(), np.float32)
    events = {}
    for name, plan in (("jax", jplan.ReconstructionPlan(geometry=g)),
                       ("torch", tplan.ReconstructionPlan(geometry=tg,
                                                          device="cpu"))):
        trace = PACKAGES[name][1]
        fn = plan.build()
        prev = trace.set_tracer(trace.Tracer(enabled=False))
        try:
            fn(proj)
            assert trace.get_tracer().events() == []
            trace.enable()
            fn(proj)
            events[name] = trace.get_tracer().spans("engine.")
        finally:
            trace.set_tracer(prev)
    (ev,) = events["torch"]
    (ref,) = events["jax"]
    assert ev["name"] == ref["name"] == "engine.reconstruct"
    dispatch = ev["args"].pop("dispatch_us")
    assert 0 <= dispatch <= ev["dur"]
    ref["args"].pop("dispatch_us")
    assert ev["args"] == ref["args"]


def test_attribution_waits_for_its_item():
    """obs.attribution is ported: the port exports what the reference's
    obs package exports, attribution among them."""
    from repro_torch.obs import attribution
    assert tobs.attribution is attribution
    assert set(tobs.__all__) == set(__import__(
        "repro.obs", fromlist=["__all__"]).__all__)
    assert attribution.__all__ == __import__(
        "repro.obs.attribution", fromlist=["__all__"]).__all__


# ---------------------------------------------------------------------------
# obs.attribution: predicted-vs-measured rows, against the reference's
# ---------------------------------------------------------------------------

def _stage_events(seconds):
    """A Perfetto event list with one complete span per (stage, seconds),
    plus spans attribution ignores."""
    events, ts = [], 0.0
    for name, secs in seconds:
        events.append({"ph": "X", "name": name, "ts": ts, "dur": secs * 1e6,
                       "pid": 1, "tid": 1, "args": {}})
        ts += secs * 1e6
    events.append({"ph": "X", "name": "engine.traced", "ts": 0.0,
                   "dur": ts, "pid": 1, "tid": 1, "args": {}})
    events.append({"ph": "i", "name": "stage.mark", "ts": 0.0, "pid": 1,
                   "tid": 1, "s": "t"})
    return events


STAGE_RUN = [("stage.read", 0.02), ("stage.filter", 0.004),
             ("stage.allgather", 0.001), ("stage.backproject", 0.03),
             ("stage.backproject", 0.01), ("stage.reduce", 0.002)]


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("plan_kw", [
    {}, {"schedule": "pipelined", "n_steps": 2, "precision": "bf16"},
    {"impl": "kernel", "precision": "fp8_e4m3"}])
def test_attribution_compare_matches_reference(form, plan_kw):
    from repro.obs import attribution as jattr
    from repro_torch.obs import attribution as tattr
    events = _stage_events(STAGE_RUN)
    trace = {"traceEvents": events} if form == "dict" else events
    jg = jdefault_geometry(16, n_proj=8)
    want = jattr.compare(jplan.ReconstructionPlan(geometry=jg, **plan_kw),
                         trace)
    got = tattr.compare(tplan.ReconstructionPlan(
        geometry=default_geometry(16, n_proj=8), device="cpu", **plan_kw),
        trace)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert tattr.aggregate_error(got) == jattr.aggregate_error(want)
    assert tattr.render_report(got) == jattr.render_report(want)
    assert tattr.stage_totals(trace) == jattr.stage_totals(trace)
    assert tattr.STAGE_FIELDS == jattr.STAGE_FIELDS


def test_attribution_reads_the_ports_tracer():
    from repro_torch.core.perf_model import H100
    from repro_torch.obs import attribution as tattr
    from repro_torch.planner import CalibrationStore
    tracer = ttrace.Tracer(enabled=True)
    for name, secs in STAGE_RUN:
        with tracer.span(name):
            time.sleep(secs / 10)
    totals = tattr.stage_totals(tracer)
    assert totals["stage.backproject"]["n"] == 2
    assert set(totals) == {n for n, _ in STAGE_RUN}
    plan = tplan.ReconstructionPlan(geometry=default_geometry(16, n_proj=8),
                                    device="cpu")
    rows = tattr.compare(plan, tracer, H100)
    by = {r.stage: r for r in rows}
    assert [r.stage for r in rows] == list(tattr.STAGE_FIELDS)
    assert by["stage.reduce"].error is None          # C == 1: predicted 0
    assert by["stage.write"].n_spans == 0
    assert by["stage.backproject"].measured_s == pytest.approx(
        totals["stage.backproject"]["seconds"])
    store = CalibrationStore()
    store.record_traced_run(plan, {r.stage: r.measured_s for r in rows},
                            H100)
    cal = store.fit(H100, min_samples=1)
    calibrated = {r.stage: r for r in tattr.compare(plan, tracer, H100,
                                                    calibration=cal)}
    # a fit to this one run moves every fitted stage's prediction onto it
    for stage in ("stage.filter", "stage.read"):
        assert calibrated[stage].error == pytest.approx(0.0, abs=1e-9)
    assert tattr.aggregate_error(rows) > 0
