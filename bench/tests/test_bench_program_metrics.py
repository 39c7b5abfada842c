"""The per-layer metrics read from the program's own trace (the
``device_ms``, ``lanes`` and kernel counts of ``engine.batched``, the bytes
of ``service.lane.h2d``, the ``queue_ms`` of ``service.bucket``): each
reader on a hand-built trace, on a trace without those args (what a
program that lacks them leaves), and on runs of the cells at test sizes."""
import pytest

from bench_tiny import make_tree, quiet

from bench.harness import cell
from bench.harness.registry import Registry
from repro_torch.obs import trace

SEED = 2**31 + 29
CLOSED, OPEN = "rct512-device-closed", "rct512-host-open"
NEW = ("plan.filter_device_ms", "plan.relayout_device_ms", "bp.direct_share",
       "service.h2d_gbps", "service.queue_wait_ms")


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return Registry(make_tree(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def tracer():
    tr = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


def span(tr, name, dur_us, **args):
    tr._append({"ph": "X", "name": name, "ts": 0.0, "dur": dur_us,
                "pid": 1, "tid": 1, "args": args})


def read(reg, name):
    return reg.metric_reader(name)(None)


def test_readers_on_a_hand_built_trace(reg, tracer):
    span(tracer, "engine.batched", 9e5, lanes=2, batch=2,
         device_ms={"stage.filter": 30.0, "bp.operands": 8.0,
                    "bp.kernel": 300.0, "bp.unfold": 4.0,
                    "stage.reduce": 2.0, "stage.backproject": 313.0},
         direct_pairs=10, tile_pairs=1000)
    span(tracer, "engine.batched", 4e5, lanes=1, batch=1,
         device_ms={"stage.filter": 15.0, "bp.operands": 4.0,
                    "bp.unfold": 2.0, "stage.reduce": 1.0},
         direct_pairs=5, tile_pairs=500)
    span(tracer, "service.lane.h2d", 2e5, bytes=1_000_000_000, src="host")
    span(tracer, "service.lane.h2d", 3e5, bytes=2_000_000_000, src="host")
    span(tracer, "service.lane.h2d", 5e5, bytes=0, src="device")
    span(tracer, "service.bucket", 1e6, queue_ms=[1.0, 2.0, None], pads=0)
    span(tracer, "service.bucket", 1e6, queue_ms=[6.0], pads=1)
    span(tracer, "service.bucket.assemble", 1e5, queue_ms=[1000.0])
    assert read(reg, "plan.filter_device_ms") == pytest.approx(45.0 / 3)
    assert read(reg, "plan.relayout_device_ms") == pytest.approx(21.0 / 3)
    assert read(reg, "bp.direct_share") == pytest.approx(1.0)
    assert read(reg, "service.h2d_gbps") == pytest.approx(6.0)
    assert read(reg, "service.queue_wait_ms") == pytest.approx(3.0)


def test_readers_find_nothing_without_the_args(reg, tracer):
    """What a program without the spans' new args leaves: every reader
    reads nothing, and none raises."""
    span(tracer, "engine.batched", 9e5, batch=2, dispatch_us=10.0)
    span(tracer, "service.bucket", 1e6, batch=1, scans=1)
    span(tracer, "service.bucket.assemble", 1e5)
    for name in NEW:
        assert read(reg, name) is None, name
    tracer.clear()
    for name in NEW:
        assert read(reg, name) is None, name


def test_new_metrics_are_listed_for_the_cells_they_read(reg):
    for name, cells in (("plan.filter_device_ms", 2),
                        ("plan.relayout_device_ms", 2),
                        ("bp.direct_share", 2), ("service.h2d_gbps", 1),
                        ("service.queue_wait_ms", 1)):
        (m,) = [m for m in reg.spec["per_layer"] if m["name"] == name]
        assert m["source"] == "program_counter" and len(m["workloads"]) \
            == cells
        for c in m["workloads"]:
            assert m in reg.per_layer(c)


@pytest.fixture(autouse=True)
def no_tune_file(monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", "off")


def test_a_traced_closed_run_reads_the_programs_stages(reg):
    """On the CPU the stages are host-stamped and the kernel's plain
    version counts nothing: the stage and queue metrics read, the direct
    share does not."""
    res = cell.run(reg, CLOSED, SEED, 0.4, True, device="cpu",
                   log_fn=quiet)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("plan.filter_device_ms", "plan.relayout_device_ms",
                 "service.queue_wait_ms"):
        assert m[name]["value"] > 0, name
    assert "bp.direct_share" not in m
    events = trace.get_tracer().spans("service.")
    assert {"service.loop.wait", "service.schedule",
            "service.lane.h2d"} <= {e["name"] for e in events}


def test_a_traced_open_run_copies_nothing_on_the_cpu(reg):
    """The open mix's host scans are already on a CPU service's device:
    its lane spans count no bytes, so the copy rate reads nothing."""
    res = cell.run(reg, OPEN, SEED, 0.4, True, device="cpu", log_fn=quiet,
                   mix_overrides={"rate_per_s": 150.0})
    assert res["correct"], res["checks"]
    assert "service.h2d_gbps" not in res["metrics"]
    h2d = trace.get_tracer().spans("service.lane.h2d")
    assert h2d and all(e["args"]["bytes"] == 0 for e in h2d)
