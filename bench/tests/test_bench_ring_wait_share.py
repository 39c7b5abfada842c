"""The `bp.ring_wait_share` reader on hand-built traces: the ring waits of
the ``engine.batched`` spans over 32 warps times their (tile, projection)
pairs, and nothing where no span carries the waits."""
import pytest

from bench_tiny import make_tree

from bench.harness.registry import Registry
from repro_torch.obs import trace

NAME = "bp.ring_wait_share"


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return Registry(make_tree(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def tracer():
    tr = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


def span(tr, name, **args):
    tr._append({"ph": "X", "name": name, "ts": 0.0, "dur": 1e5,
                "pid": 1, "tid": 1, "args": args})


def read(reg):
    return reg.metric_reader(NAME)(None)


def test_waits_over_warp_steps(reg, tracer):
    span(tracer, "engine.batched", lanes=2, direct_pairs=10,
         tile_pairs=1000, ring_waits=640)
    span(tracer, "engine.batched", lanes=1, direct_pairs=0,
         tile_pairs=500, ring_waits=320)
    span(tracer, "service.bucket", ring_waits=10_000, tile_pairs=1)
    assert read(reg) == pytest.approx(100.0 * 960 / (32 * 1500))


def test_spans_without_the_arg_are_left_out(reg, tracer):
    """A fence that read no ring waits (a launch of a kernel without the
    ring) adds none of its pairs either."""
    span(tracer, "engine.batched", lanes=1, direct_pairs=0, tile_pairs=500)
    span(tracer, "engine.batched", lanes=1, direct_pairs=0,
         tile_pairs=100, ring_waits=0)
    assert read(reg) == 0.0


@pytest.mark.parametrize("args", [
    {}, {"direct_pairs": 3, "tile_pairs": 1000}, None])
def test_nothing_to_read(reg, tracer, args):
    """Spans without the arg, as the parent's program leaves them, or no
    span at all: the reader reads nothing and does not raise."""
    if args is not None:
        span(tracer, "engine.batched", lanes=1, **args)
    assert read(reg) is None


def test_listed_for_both_closed_cells(reg):
    (m,) = [m for m in reg.spec["per_layer"] if m["name"] == NAME]
    assert m["source"] == "program_counter" and m["moves"] == "gups"
    assert m["layer"] == "back-projection kernel" and m["unit"] == "%"
    assert sorted(m["workloads"]) == ["rct1024-device-closed",
                                      "rct512-device-closed"]
    for c in m["workloads"]:
        assert m in reg.per_layer(c)
