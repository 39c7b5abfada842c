"""The end-to-end arithmetic: tails over every scan due, rates over all the
work and all its time."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401
from bench.harness import stats


def window(ttv, landed=None, last=10.0):
    landed = len(ttv) if landed is None else landed
    return {"ttv": ttv, "landed": landed, "last_landed_s": last,
            "updates": landed * 2.0**30, "setup_s": 12.5}


@pytest.mark.parametrize("q", [0, 10, 50, 80, 90, 99, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(q).exponential(1.0, 137))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_a_stall_moves_the_tail_and_not_the_median():
    steady = [0.2] * 100
    stalled = [0.2] * 85 + [2.0] * 15
    before, after = window(steady), window(stalled)
    assert stats.end_to_end("ttv_p90_s", before) == pytest.approx(0.2)
    assert stats.end_to_end("ttv_p90_s", after) == pytest.approx(2.0)
    assert stats.end_to_end("ttv_p50_s", after) == pytest.approx(0.2)


def test_rates_take_all_the_work_over_all_its_time():
    w = window([0.2] * 40, landed=39, last=7.8)
    assert stats.end_to_end("gups", w) == pytest.approx(39 / 7.8)
    assert stats.end_to_end("scans_per_s", w) == pytest.approx(39 / 7.8)
    assert stats.end_to_end("setup_s", w) == 12.5
    with pytest.raises(ValueError):
        stats.end_to_end("gups", window([0.2], landed=0))
    with pytest.raises(KeyError):
        stats.end_to_end("tokens_per_s", w)

