"""The stream cell (`rct512-stream`, bench/traffic/loops/stream.py): its
schedule, its two per-layer readers, and whole runs at test sizes on the
CPU, sound and with a fault planted in the session's fold."""
import contextlib
import json
from unittest import mock

import numpy as np
import pytest
import torch

from bench_tiny import ROOT, make_tree, quiet

from bench.harness import cell, traffic
from bench.harness.registry import Registry
from repro_torch.obs import trace

SEED = 2**31 + 53
SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
CELL = "rct512-stream"
MIX = json.loads((ROOT / "bench/traffic/stream.json").read_text())
N_PROJ = 496
READERS = ("stream.tail_device_ms", "stream.delta_wait_ms")


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return Registry(make_tree(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def loop():
    return Registry(ROOT).loop("stream")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the program's CPU tests run: the loop's
    threads then do not wait on a pool that spins on every core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def no_tune_file(monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", "off")


@pytest.fixture
def tracer():
    tr = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


def lands(spins, seconds):
    return sorted(t for s in spins for t in s.lands if t < seconds)


def test_the_mix_is_valid_and_its_rooms_share_no_phase(reg, loop):
    traffic.validate(dict(MIX), reg.loops())
    t = loop.period(MIX, N_PROJ)
    assert t == pytest.approx(62 / 30)
    with pytest.raises(ValueError, match="shares a factor"):
        loop.schedule(dict(MIX, rooms=12), N_PROJ, 51.0, SEED)
    with pytest.raises(ValueError, match="equal deltas"):
        loop.delta_slices(MIX, 490)


def test_every_seed_gets_the_same_work(loop):
    runs = [loop.schedule(MIX, N_PROJ, 51.0, s) for s in SEEDS]
    first = runs[0]
    for spins in runs:
        assert len(spins) == len(first)
        assert np.allclose(lands(spins, 51.0), lands(first, 51.0))
        assert sorted(s.due for s in spins) == pytest.approx(
            sorted(s.due for s in first))
        assert all(s.slices == tuple(loop.delta_slices(MIX, N_PROJ))
                   for s in spins)
    # the seed moves rooms between slots, and so which scan lands when
    assert len({tuple(s.room for s in spins) for spins in runs}) > 1
    assert loop.schedule(MIX, N_PROJ, 51.0, SEED) == loop.schedule(
        MIX, N_PROJ, 51.0, SEED)


def test_deltas_land_at_distinct_phases_a_room_apart(loop):
    t = loop.period(MIX, N_PROJ)
    spins = loop.schedule(MIX, N_PROJ, 51.0, SEED)
    gaps = np.diff(lands(spins, 51.0))
    assert gaps.min() >= t / MIX["rooms"] - 1e-9
    phases = {round((s.lands[0] % t) / t * MIX["rooms"]) % MIX["rooms"]
              for s in spins}
    assert len(phases) == MIX["rooms"]
    by_room = {}
    for s in spins:
        by_room.setdefault(s.room, []).append(s)
    for room in by_room.values():
        for a, b in zip(room, room[1:]):
            # one delta period of repositioning between a room's spins
            assert b.lands[0] - a.due == pytest.approx(2 * t)


def test_the_count_of_scans_due(loop):
    spins = loop.schedule(MIX, N_PROJ, 51.0, SEED)
    due = [s for s in spins if s.due < 51.0]
    # every room's first spin; 14 rooms' second (C = 9 T = 18.6 s)
    assert len(due) == 30
    assert sorted(np.bincount([s.room for s in due])) == [1] * 2 + [2] * 14
    assert len(lands(spins, 51.0)) == 291
    assert {s.pool for s in due} == {0, 1}


def span(tr, name, dur_us, **args):
    tr._append({"ph": "X", "name": name, "ts": 0.0, "dur": dur_us,
                "pid": 1, "tid": 1, "args": args})


def context(reg):
    return cell.TraceContext(
        registry=reg, geometry=None, config=reg.config("rabbitct-512-stream"),
        device=None, device_kind="cpu", scans=2, window_s=1.0, busy_s=0.1,
        ops=[], service={})


def test_readers_on_a_synthetic_trace(reg, tracer):
    ctx = context(reg)
    assert [reg.metric_reader(n)(ctx) for n in READERS] == [None, None]
    for wait_ms in (0.5, 0.25, 0.75, 1.0):
        span(tracer, "service.stream.fold", 3e4, wait_ms=wait_ms)
    span(tracer, "session.fold", 3e4, final=False,
         device_ms={"stage.filter": 0.9, "filter.kernel": 0.6,
                    "stage.backproject": 20.0, "bp.kernel": 19.0,
                    "stream.accumulate": 0.4})
    span(tracer, "session.fold", 3e4, final=True,
         device_ms={"stage.filter": 0.9, "filter.kernel": 0.6,
                    "stage.backproject": 20.0, "bp.kernel": 19.0,
                    "stream.accumulate": 0.4, "stream.finalize": 0.3})
    span(tracer, "session.fold", 3e4, final=True,
         device_ms={"stage.filter": 0.8, "filter.kernel": 0.5,
                    "stage.backproject": 21.0, "stream.accumulate": 0.4,
                    "stream.finalize": 0.1})
    span(tracer, "session.fold", 3e4, final=True)      # no stage times
    assert reg.metric_reader("stream.tail_device_ms")(ctx) == \
        pytest.approx((21.3 + 22.0) / 2)
    assert reg.metric_reader("stream.delta_wait_ms")(ctx) == \
        pytest.approx(2.5 / 4)


def run(reg, trace_=False, seconds=1.3):
    return cell.run(reg, CELL, SEED, seconds, trace_, device="cpu",
                    log_fn=quiet)


def test_sound_runs_are_correct_and_report_their_metrics(reg):
    res = run(reg)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 4 and res["failed"] == 0
    m = res["metrics"]
    assert set(m) == {"ttv_p50_s", "setup_s"}
    assert 0 < m["ttv_p50_s"]["value"] < 5.0
    res = run(reg, trace_=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(READERS)
    assert res["metrics"]["stream.tail_device_ms"]["value"] > 0
    assert res["metrics"]["stream.delta_wait_ms"]["value"] >= 0


@contextlib.contextmanager
def fold_fault(kind):
    """The session's fold of the delta of angles from 0 skipped, or run
    twice, while the stream still completes."""
    from repro_torch.core.plan import IncrementalSession
    real = IncrementalSession._fold

    def fold(self, pm_col, q_col, sc_col):
        first = pm_col.data_ptr() == self._pmats.data_ptr()
        if kind == "skipped" and first:
            return
        real(self, pm_col, q_col, sc_col)
        if kind == "twice" and first:
            real(self, pm_col, q_col, sc_col)
    with mock.patch.object(IncrementalSession, "_fold", fold):
        yield


@pytest.mark.parametrize("kind", ["skipped", "twice"])
def test_a_delta_skipped_or_folded_twice_is_not_correct(reg, kind):
    with fold_fault(kind):
        res = run(reg)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["rel_rmse"]["value"] > \
        res["checks"]["rel_rmse"]["limit"]


def test_a_program_that_cannot_stream_fails_at_once(reg, monkeypatch):
    from repro_torch.service import ReconstructionService
    monkeypatch.delattr(ReconstructionService, "open_stream")
    with pytest.raises(RuntimeError, match="open_stream"):
        run(reg)
