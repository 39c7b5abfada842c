"""The one traffic generator: a mix's parameters and a seed in, a schedule out.

A mix (bench/traffic/<name>.json) states:

  loop          the loop that drives the window, found by name as
                bench/traffic/loops/<loop>.py: "closed", one client
                submitting its next scan when its previous volume lands;
                "open", arrivals at `rate_per_s` a second, whatever the
                service does. A new loop is a new file there (see
                bench/harness/client.py for what it defines)
  arrivals      (open) "poisson": exponential gaps
  placement     "device": each scan is already on the card when it is due
                (a frame grabber writing to device memory); "host": it
                arrives whole in pageable host memory
  pool          scans made from the seed, reused in turn
  warm_buckets  the bucket sizes set-up serves once before the window

Every seed gets the same work: the open loop's gaps are the quantiles of
the exponential distribution at the mix's rate, in an order drawn from
the seed, and each pool scan is submitted equally often. So seeds differ
in the order of arrivals and in the phantoms, not in how much arrives.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

PLACEMENTS = ("device", "host")


def validate(mix: dict, loops: Iterable[str]) -> dict:
    """`mix`, once its fields are found sound; `loops` are the loops the
    benchmark has."""
    loops = tuple(loops)
    if mix["loop"] not in loops:
        raise ValueError(f"loop {mix['loop']!r} is not one of {loops}")
    if mix["placement"] not in PLACEMENTS:
        raise ValueError(
            f"placement {mix['placement']!r} is not one of {PLACEMENTS}")
    if mix["loop"] == "open" and mix.get("arrivals") != "poisson":
        raise ValueError("an open loop needs arrivals 'poisson'")
    if mix["loop"] == "closed" and mix.get("clients", 1) != 1:
        raise ValueError("a closed loop here has one client")
    if int(mix["pool"]) < 1:
        raise ValueError("pool must hold at least one scan")
    return mix


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def open_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Offsets (s) of the arrivals due in a window of `seconds`: the first
    at 0, then floor(rate * seconds) - 1 gaps, the exponential quantiles
    at `rate` in a seeded order. Every seed gets the same set of gaps."""
    n = max(1, int(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = _rng(seed, 1).permutation(gaps)
    t = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return t[t < seconds]


def pool_order(n: int, pool: int, seed: int) -> List[int]:
    """Which pool scan each of `n` open-loop arrivals carries: each as
    often as the others, in a seeded order."""
    return [int(p) for p in _rng(seed, 2).permutation(np.arange(n) % pool)]
