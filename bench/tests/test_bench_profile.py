"""The reduction of a traced window: busy time, idle gaps and their labels,
the operations taking most time."""
import json

import pytest

import bench_tiny  # noqa: F401
from bench.harness import profile


def chrome(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_reads_device_operations_and_the_marker(tmp_path):
    path = chrome(tmp_path / "t.json", [
        {"ph": "X", "cat": "kernel", "name": "void k<float, 8>(float*, int)",
         "ts": 110.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "ts": 100.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 90.0,
         "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": profile.MARKER,
         "ts": 95.0, "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "not complete", "ts": 1.0},
    ])
    ops, marker = profile.read_trace(path)
    assert marker == 95.0
    assert [o.cat for o in ops] == ["gpu_memcpy", "kernel"]
    assert profile.short_name(ops[1].name) == "k<float, 8>"
    assert profile.short_name(ops[0].name) == ops[0].name


def test_busy_union_and_gaps():
    ops = [profile.DeviceOp("a", "kernel", 0.0, 10.0),
           profile.DeviceOp("b", "kernel", 5.0, 10.0),      # overlaps a
           profile.DeviceOp("c", "gpu_memcpy", 30.0, 10.0),
           profile.DeviceOp("d", "kernel", 90.0, 20.0)]     # past the end
    busy = profile.busy_intervals(ops, 2.0, 100.0)
    assert busy == [(2.0, 15.0), (30.0, 40.0), (90.0, 100.0)]
    assert profile.idle_gaps(busy, 2.0, 100.0) == [(15.0, 30.0), (40.0, 90.0)]
    assert profile.idle_gaps([], 0.0, 5.0) == [(0.0, 5.0)]


def test_gaps_take_the_innermost_span_of_the_first_set_that_has_one():
    program = [profile.HostSpan("service.drain", 0.0, 100.0),
               profile.HostSpan("service.bucket.assemble", 10.0, 20.0)]
    client = [profile.HostSpan("bench.wait", 0.0, 200.0)]
    gaps = [(12.0, 14.0), (50.0, 60.0), (150.0, 170.0), (300.0, 301.0)]
    out = profile.label_gaps(gaps, program, client)
    assert out == pytest.approx({"service.bucket.assemble": 2e-6,
                                 "service.drain": 10e-6,
                                 "bench.wait": 20e-6, "no span": 1e-6})


def test_top_operations_sum_by_short_name():
    ops = [profile.DeviceOp("void k<1>(int)", "kernel", 0.0, 2e6),
           profile.DeviceOp("void k<1>(float)", "kernel", 0.0, 1e6),
           profile.DeviceOp("m", "gpu_memset", 0.0, 0.5e6)]
    assert profile.top_ops(ops, 1) == [["k<1>", 3.0]]
