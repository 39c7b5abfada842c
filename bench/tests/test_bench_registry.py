"""A configuration, a traffic mix, a per-layer metric or a kernel family
added as files of its own is found by its name, with no file edited."""
import json

import pytest

from bench_tiny import make_tree, quiet

from bench.harness import cell
from bench.harness.registry import Registry


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path)


def add_cell(root, spec):
    cfg = json.loads((root / "bench/configs/rabbitct-512.json").read_text())
    cfg["name"] = "rabbitct-256"
    (root / "bench/configs/rabbitct-256.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/device-burst.json").write_text(json.dumps(
        {"loop": "open", "arrivals": "poisson", "rate_per_s": 9.0,
         "placement": "device", "pool": 3, "warm_buckets": [1, 2]}))
    (root / "bench/metrics/plan.filter_ms.py").write_text(
        "def read(ctx):\n    return 4.5\n")
    (root / "bench/roofline/names/backproject/bp_next.json").write_text(
        json.dumps({"kernels": ["bp_next_kernel"]}))
    (root / "bench/roofline/ramp.py").write_text("OPS = 3\n")
    spec["configs"].append({"name": "rabbitct-256", "source": "x",
                            "file": "bench/configs/rabbitct-256.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "rct256-burst", "config": "rabbitct-256",
                              "traffic": "device-burst", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "ttv_p99_s", "unit": "s",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["rct256-burst"]})
    spec["per_layer"].append({"name": "plan.filter_ms", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "plan, filter and codec",
                              "moves": "ttv_p99_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_files_are_found_by_name(tree):
    before = {p: p.read_bytes() for p in (tree / "bench").rglob("*")
              if p.is_file()}
    add_cell(tree, json.loads((tree / "BENCHMARK.json").read_text()))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    reg = Registry(tree)
    cell = reg.cell("rct256-burst")
    assert reg.config(cell["config"])["name"] == "rabbitct-256"
    assert reg.traffic(cell["traffic"])["rate_per_s"] == 9.0
    assert {m["name"] for m in reg.end_to_end("rct256-burst")} == {
        "ttv_p99_s", "setup_s"}
    # a metric with no `workloads` is read wherever its end-to-end metric is
    assert [m["name"] for m in reg.per_layer("rct256-burst")] == [
        "plan.filter_ms"]
    assert reg.metric_reader("plan.filter_ms")(None) == 4.5
    # a metric split by what it moves shares its quantity's reader
    assert reg.metric_reader("plan.filter_ms.closed")(None) == 4.5
    assert reg.kernel_names("backproject") == ["bp_dual_kernel",
                                               "bp_next_kernel"]
    assert reg.kernel_count("ramp").OPS == 3


def test_each_cell_reads_what_benchmark_json_lists(tree):
    reg = Registry(tree)
    spec = reg.spec
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in reg.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = reg.per_layer(cell["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e
            assert callable(reg.metric_reader(m["name"]))
        reg.traffic(cell["traffic"])
        assert "limits" in reg.config(cell["config"])


def test_unknown_names_are_refused(tree):
    reg = Registry(tree)
    with pytest.raises(KeyError):
        reg.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        reg.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        reg.metric_reader("no.such_metric")
    with pytest.raises(FileNotFoundError):
        reg.loop("no-such-loop")


# A traffic loop of its own, as a later change would add it: two scan
# families of different volume sizes, each warmed once, sent in one burst.
BURST_LOOP = """
from bench.harness.client import PoolScan, Scan
from bench.reference import phantom
from bench.reference.geometry import Geometry


def make_pool(config, seed, mix, device):
    pool = []
    for k, sizes in enumerate(mix["families"]):
        g = Geometry.from_dict(dict(config["geometry"], **sizes))
        pool.append(PoolScan(g, phantom.project(
            g, phantom.ellipsoids(seed, k), device)))
    return pool


def warm(client, mix, stamp):
    for p in range(len(client.pool)):
        t = client.svc.submit(projections=client.pool[p].projections,
                              geometry=client.program_geometry(p))
        client.svc.drain()
        t.result()
    client.svc.serve()
    stamp("each family served once")


def drive(client, mix, t_start, seconds, seed):
    scans = [Scan(due=t_start, pool=k % len(client.pool))
             for k in range(int(mix["burst"]))]
    for s in scans:
        client.submit(s)
    for s in scans:
        client.receive(s)
    return scans
"""


def test_a_new_traffic_loop_is_found_and_drives_a_run(tree, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", "off")
    before = {p: p.read_bytes() for p in (tree / "bench").rglob("*")
              if p.is_file()}
    (tree / "bench/traffic/loops/burst.py").write_text(BURST_LOOP)
    (tree / "bench/traffic/two-family-burst.json").write_text(json.dumps(
        {"loop": "burst", "placement": "device", "pool": 2, "burst": 5,
         "families": [{}, {"n_x": 12, "n_y": 12, "n_z": 12,
                           "d_x": 2 / 12, "d_y": 2 / 12, "d_z": 2 / 12}]}))
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rct-burst", "config": "rabbitct-512",
                              "traffic": "two-family-burst", "chips": 1,
                              "why": "x"})
    next(m for m in spec["end_to_end"] if m["name"] == "gups")[
        "workloads"].append("rct-burst")
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    reg = Registry(tree)
    assert "burst" in reg.loops()
    # the burst is all the window holds: long enough for it to land inside
    res = cell.run(reg, "rct-burst", 2**31 + 29, 60.0, False, device="cpu",
                   log_fn=quiet)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 5 and res["failed"] == 0
    assert res["metrics"]["gups"]["value"] > 0
