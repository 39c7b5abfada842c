"""The arithmetic of the end-to-end metrics.

  ttv_p<N>_s  the N-th percentile of every scan due in the window, from
              when it was due to when the client saw its volume (linear
              between closest ranks, as numpy's default). A scan that
              failed, or never landed, counts at the time the client gave
              up on it, a lower bound.
  gups        N_x N_y N_z N_p of every volume that landed inside the window,
              over the seconds from the window's start to the last of
              those landings, times 2^30 (the paper's giga voxel updates
              per second; all the work over all the time it took; ending
              at the last landing keeps a whole 1024^3 volume, 2 % of a
              window's work, from quantising the rate).
  scans_per_s volumes landed inside the window over the seconds from the
              window's start to the last of those landings (an open loop
              above the knee: the rate the service sustains).
  setup_s     from the process's start to the first timed submit.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence

_TTV = re.compile(r"ttv_p(\d+(?:\.\d+)?)_s")


def percentile(samples: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between closest ranks."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def gups(voxel_updates: float, seconds: float) -> float:
    return voxel_updates / (seconds * 2**30)


def end_to_end(name: str, run: dict) -> Optional[float]:
    """Metric `name` of a finished window. `run` holds `ttv` (seconds, one
    per scan due), `landed` (volumes landed inside the window),
    `last_landed_s` (the last of those landings, from the window's
    start), `updates` (N_x N_y N_z N_p summed over those volumes) and
    `setup_s`."""
    if name == "setup_s":
        return run["setup_s"]
    if name == "gups":
        if not run["landed"]:
            raise ValueError("no volume landed inside the window")
        return gups(run["updates"], run["last_landed_s"])
    if name == "scans_per_s":
        if not run["landed"]:
            raise ValueError("no volume landed inside the window")
        return run["landed"] / run["last_landed_s"]
    m = _TTV.fullmatch(name)
    if m:
        return percentile(run["ttv"], float(m.group(1)))
    raise KeyError(f"no rule computes the end-to-end metric {name!r}")

