"""The one traffic generator: a seed gives the same schedule every time,
and every seed the same amount of work."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the checkout on the path)
from bench.harness import traffic

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_open_schedule_repeats_exactly(seed):
    a = traffic.open_arrivals(2.0, 51.0, seed)
    b = traffic.open_arrivals(2.0, 51.0, seed)
    assert np.array_equal(a, b)
    assert traffic.pool_order(len(a), 4, seed) == traffic.pool_order(
        len(b), 4, seed)


def test_every_seed_gets_the_same_gaps_in_another_order():
    runs = [traffic.open_arrivals(2.0, 51.0, s) for s in SEEDS]
    assert len({len(r) for r in runs}) == 1
    assert len(runs[0]) == int(2.0 * 51.0)
    gaps = [np.round(np.diff(r), 9) for r in runs]
    # each run drops one gap of the same multiset: all but one agree
    for g in gaps[1:]:
        assert np.isin(g, gaps[0]).sum() >= len(g) - 1
    assert not np.array_equal(runs[0], runs[1])


def test_arrivals_are_poisson_at_the_rate():
    t = traffic.open_arrivals(2.0, 51.0, 1)
    assert t[0] == 0.0 and np.all(np.diff(t) > 0) and t[-1] < 51.0
    assert np.diff(t).mean() == pytest.approx(0.5, rel=0.05)


def test_pool_order_is_balanced():
    order = traffic.pool_order(100, 4, 3)
    assert sorted(order.count(p) for p in range(4)) == [25, 25, 25, 25]


@pytest.mark.parametrize("mix", [
    {"loop": "sideways", "placement": "host", "pool": 1},
    {"loop": "open", "placement": "host", "pool": 1, "arrivals": "bursty"},
    {"loop": "closed", "placement": "disk", "pool": 1},
    {"loop": "closed", "placement": "host", "pool": 0},
])
def test_malformed_mixes_are_refused(mix):
    with pytest.raises(ValueError):
        traffic.validate(mix, ("closed", "open"))
