"""Offered-rate sweep of an open-loop cell, to find its knee: the highest
rate at which the queue does not grow over the window.

    python3 bench/sweep.py --workload rct512-host-open --rates 1.5,2,2.5 \
        --seconds 30 --seed <n>

For each rate, one run of the cell at that rate (set-up, window, check),
and one JSON line: the time-to-volume percentiles, the mean time to volume
of the window's first and last thirds of arrivals (a growing queue shows
as the last third waiting longer), the scans still out when the window
closed, and the rate at which volumes landed inside the window (above the
knee it stays at the knee, whatever is offered).
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cell, stats  # noqa: E402
from bench.harness.registry import Registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args(argv)
    reg = Registry(ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        res = cell.run(reg, args.workload, args.seed, args.seconds, False,
                       mix_overrides={"rate_per_s": rate})
        tl = res["timeline"]
        ttv = [t for _, t in tl]
        third = max(1, len(tl) // 3)
        inside = [due + t for due, t in tl if due + t <= args.seconds]
        print(json.dumps({
            "rate_per_s": rate, "scans": len(tl), "correct": res["correct"],
            "ttv_p50_s": stats.percentile(ttv, 50),
            "ttv_p90_s": stats.percentile(ttv, 90),
            "first_third_mean_s": statistics.mean(ttv[:third]),
            "last_third_mean_s": statistics.mean(ttv[-third:]),
            "out_at_close": sum(1 for due, t in tl
                                if due + t > args.seconds),
            "landed_per_s": len(inside) / max(inside)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
