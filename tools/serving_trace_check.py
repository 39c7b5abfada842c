"""Holds the program's own serving-path trace against the device trace of
the same run, and measures what the tracer costs, on a CUDA card.

    python3 tools/serving_trace_check.py --workload <cell> --seed <n> \\
        --seconds <s> [--modes traced,plain,tracer]

from the root of a checkout. Each mode is one run of the benchmark's cell
(bench/harness/cell.py) in this process, in the order given:

  traced  the window under torch.profiler and the program's tracer, as
          `bench/run.py --trace 1`: the per-layer metrics, and per lane run
          the program's device stages beside the device trace —
          `bp.kernel` against the back-projection kernels' time; the
          filter and relayout against every other device operation
          (`plan.nonbp_device_ms`); the lane copies' rate
          (`service.h2d_gbps`) against the HtoD copies' device rate — and
          the idle seconds by label;
  plain   no tracing, as `--trace 0`: the end-to-end metrics, the mean
          time to volume and, in a closed loop, the client's gap from a
          volume's landing to the next submit;
  tracer  the program's tracer alone on (no profiler): the end-to-end
          metrics, to set against `plain` for the tracer's cost.

Prints one JSON object per mode on standard output; the harness's log
goes to standard error.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cell, stats  # noqa: E402
from bench.harness.registry import Registry  # noqa: E402

RELAYOUT = ("bp.operands", "bp.unfold", "stage.reduce")


def stage_sums(events):
    """(lanes run, {stage: ms}) of the window's batched engine spans."""
    lanes, ms = 0, {}
    for e in events:
        if e.get("ph") != "X" or e["name"] != "engine.batched":
            continue
        args = e.get("args", {})
        lanes += args.get("lanes", 0)
        for k, v in args.get("device_ms", {}).items():
            ms[k] = ms.get(k, 0.0) + v
    return lanes, ms


def traced(reg, name, seed, seconds):
    from repro_torch.obs.trace import get_tracer
    captured = []
    real = cell._trace_context

    def capture(*args, **kwargs):
        ctx, breakdown = real(*args, **kwargs)
        captured.append((ctx.kernel_seconds("backproject"),
                         ctx.device_seconds(),
                         ctx.device_seconds("gpu_memcpy", "HtoD"),
                         ctx.scans))
        return ctx, breakdown
    cell._trace_context = capture
    try:
        res = cell.run(reg, name, seed, seconds, True)
    finally:
        cell._trace_context = real
    kernel_s, device_s, h2d_s, scans = captured[0]
    events = get_tracer().events()
    lanes, ms = stage_sums(events)
    host = [e for e in events if e.get("ph") == "X"
            and e["name"] == "service.lane.h2d"
            and e.get("args", {}).get("src") == "host"]
    nbytes = sum(e["args"]["bytes"] for e in host)
    idle = res["window_s"] - res["busy_s"]
    gaps = dict(res["breakdown"]["idle_gaps"])
    outside = sum(v for k, v in gaps.items()
                  if k == "no span" or k.startswith("bench."))
    out = {
        "mode": "traced", "correct": res["correct"], "scans": scans,
        "lanes": lanes, "metrics": {k: v["value"]
                                    for k, v in res["metrics"].items()},
        "stage_ms_per_lane": {k: v / lanes for k, v in sorted(ms.items())}
        if lanes else {},
        "trace_bp_kernel_ms_per_lane": 1e3 * kernel_s / lanes
        if lanes else None,
        "trace_nonbp_ms_per_lane": 1e3 * (device_s - kernel_s) / lanes
        if lanes else None,
        "inside_nonbp_ms_per_lane": sum(
            ms.get(k, 0.0) for k in ("stage.filter",) + RELAYOUT)
        / lanes if lanes else None,
        "lane_copy_bytes": nbytes,
        "device_h2d_gbps": nbytes / h2d_s / 1e9 if h2d_s and nbytes
        else None,
        "window_s": res["window_s"], "idle_s": idle,
        "idle_by_label": gaps,
        "no_span_and_bench_share_of_idle": outside / idle if idle else None,
    }
    if out["trace_bp_kernel_ms_per_lane"]:
        out["bp_kernel_vs_trace"] = (out["stage_ms_per_lane"].get(
            "bp.kernel", 0.0) / out["trace_bp_kernel_ms_per_lane"] - 1.0)
        out["nonbp_inside_vs_trace"] = (out["inside_nonbp_ms_per_lane"]
                                        / out["trace_nonbp_ms_per_lane"]
                                        - 1.0)
    return out


def untraced(reg, name, seed, seconds, tracer_on):
    from repro_torch.obs.trace import get_tracer
    tracer = get_tracer()
    tracer.enabled = tracer_on
    tracer.clear()
    try:
        res = cell.run(reg, name, seed, seconds, False)
    finally:
        tracer.enabled = False
    timeline = res["timeline"]
    ttv = sorted(t for _, t in timeline)
    # a closed loop's client gap: from a volume's landing to the next
    # scan's submit (the next scan is due at its submit)
    gaps = sorted(1e3 * (due1 - (due0 + t0)) for (due0, t0), (due1, _)
                  in zip(timeline, timeline[1:]))
    return {"mode": "tracer" if tracer_on else "plain",
            "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "ttv_p50_s_all": stats.percentile(ttv, 50),
            "ttv_mean_s": sum(ttv) / len(ttv),
            "client_gap_ms": {"p50": stats.percentile(gaps, 50),
                              "mean": sum(gaps) / len(gaps),
                              "p99": stats.percentile(gaps, 99),
                              "max": gaps[-1]} if gaps else None,
            "scans": len(ttv), "dropped_events": tracer.dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="traced,plain,tracer")
    args = ap.parse_args(argv)
    import torch
    reg = Registry(ROOT)
    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        if mode == "traced":
            out = traced(reg, args.workload, args.seed, args.seconds)
        else:
            out = untraced(reg, args.workload, args.seed, args.seconds,
                           mode == "tracer")
        out.update(workload=args.workload, seed=args.seed,
                   card=torch.cuda.get_device_name(0),
                   run_s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
