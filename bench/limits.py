"""Readings that the check's limits are set from: the program's sound runs
on many seeds and the control's, in one process.

    python3 bench/limits.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 4 [--control-precision bf16]

Each run is a short window of the cell at its own sizes and load, checked
as bench/run.py checks it. The control is the program itself with the
configuration's plan spec at a lower precision of its own stream codec:
by default bf16, the control for a stated float32 where no matrix unit
is involved (so not TF32). `--control-precision fp16` reads the codec
that lies between the two (10 mantissa bits to bf16's 7, the program's
own CUDA default). `--seeds 0` reads only the control. Prints one JSON
line per run and, last, the largest sound reading and the smallest
control reading of each number compared.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cell  # noqa: E402
from bench.harness.registry import Registry  # noqa: E402


def lower_spec(spec: str, precision: str) -> str:
    fields = cell.spec_fields(spec)
    fields["precision"] = precision
    return ",".join(f"{k}={v}" for k, v in fields.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-precision", default="bf16")
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    args = ap.parse_args(argv)
    reg = Registry(ROOT)
    spec = reg.config(reg.cell(args.workload)["config"])["plan"]
    runs = ([("sound", None)] * args.seeds
            + [("control", lower_spec(spec, args.control_precision))]
            * args.control_seeds)
    seen = {"sound": {}, "control": {}}
    for k, (mode, run_spec) in enumerate(runs):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        res = cell.run(reg, args.workload, seed, args.seconds, False,
                       spec=run_spec)
        numbers = {n: c["value"] for n, c in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "mode": mode,
                          "spec": run_spec or spec, "seed": seed,
                          "attempted": res["attempted"],
                          "correct": res["correct"], "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for n, v in numbers.items():
            seen[mode].setdefault(n, []).append(v)
    print(json.dumps({
        "workload": args.workload,
        "lower": {n: max(v) for n, v in seen["sound"].items()},
        "upper": {n: min(v) for n, v in seen["control"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
