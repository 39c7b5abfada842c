"""Runs one cell of the benchmark once and prints its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). The program
under test is the PyTorch and CUDA package under `src/`. The last line of
standard output is the result object (an open loop's generator lateness
is the line before it); the numbers the check compared, each beside its
limit, are the last lines of standard error. Exits 2
without a result when the machine lacks the cards the cell asks for, and
3 when the process holds JAX or the JAX package once the window has
closed.
"""
import os
import sys
import time

T_TOP = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (0.0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


T_PROCESS = T_TOP - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cell, hygiene  # noqa: E402
from bench.harness.registry import Registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    reg = Registry(ROOT)
    chips = reg.cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        cell.log(f"{args.workload} needs {chips} CUDA device(s); this "
                 f"machine has {torch.cuda.device_count()}")
        return 2
    res = cell.run(reg, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_process=T_PROCESS)
    found = hygiene.forbidden(sys.modules)
    if found:
        cell.log(f"the process holds {found} after the window: the "
                 "benchmark runs without JAX and the JAX package")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    if res["lateness"]:
        print(res["lateness"], flush=True)
    for name, c in res["checks"].items():
        cell.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
