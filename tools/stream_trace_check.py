"""Holds the stream cell's `stream.tail_device_ms` against the device
trace of the same run, and takes its time to volume apart, on a CUDA card.

    python3 tools/stream_trace_check.py --seed <n> --seconds <s> [--trace 0]

from the root of a checkout. Runs the benchmark's `rct512-stream` cell once
(bench/harness/cell.py) and prints one JSON object: the run's metrics,
memory peak, each scan's time to volume, the generator's lateness, and each
scan's tail on the host clock (its last delta's arrival to its fold's
start, that fold to DONE, DONE to the client). Traced (`--trace 1`, the
default, as `bench/run.py --trace 1`), also the busy share, each final
fold's wait, span and device stages, and, over the folds that finished a
stream and over all of the window's, the device stages the program timed
(``device_ms`` of each ``session.fold``) beside the device time of the
operations each fold launched in the profiler's trace (`fold_times`), and
their ratio. The harness's log goes to standard error.
"""
import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import cell, profile  # noqa: E402
from bench.harness.registry import Registry  # noqa: E402

CELL = "rct512-stream"
# the stages `stream.tail_device_ms` sums, and the filter's wider stage
STAGES = ("filter.kernel", "stage.backproject", "stream.accumulate",
          "stream.finalize")
SHOWN = STAGES + ("stage.filter",)


def spans(events, name):
    return sorted((e for e in events
                   if e.get("ph") == "X" and e["name"] == name),
                  key=lambda e: e["ts"])


def final_folds(events):
    """Per fold that finished a stream, in time order: its wait (the
    service's span), its span and its device stages (the session's), in
    ms."""
    return [{"wait_ms": e["args"]["wait_ms"], "span_ms": f["dur"] / 1e3,
             "stages_ms": {s: f["args"].get("device_ms", {}).get(s, 0.0)
                           for s in SHOWN}}
            for e, f in zip(spans(events, "service.stream.fold"),
                            spans(events, "session.fold"))
            if f.get("args", {}).get("final")]


# A fold launches the filter kernel once, first: the k-th launch in the
# window is the k-th fold's. The device operations of a fold are those
# from its launch to the length of its (fenced) ``session.fold`` span
# later, less the client's sampled read of a landed volume.
FILTER = "ramp_filter_kernel"
NOT_FOLD = ("indexSelect",)


def fold_times(events, ops):
    """{final, all}: folds, their stages' ms, and the ms of the device
    operations each fold launched (the window's k-th filter launch
    starting the k-th fold's), with those operations' ms by name for the
    final folds."""
    folds = spans(events, "session.fold")
    ops = sorted(ops, key=lambda o: o.start_us)
    starts = [o.start_us for o in ops]
    launches = [o.start_us for o in ops if FILTER in o.name]
    if len(launches) != len(folds):
        return {"error": f"{len(folds)} folds but {len(launches)} filter "
                         "launches in the window"}
    out = {k: {"folds": 0, "stages_ms": 0.0, "device_ops_ms": 0.0}
           for k in ("final", "all")}
    by_name = {}
    for e, t0 in zip(folds, launches):
        args = e.get("args", {})
        seg = ops[bisect.bisect_left(starts, t0):
                  bisect.bisect_left(starts, t0 + e["dur"])]
        seg = [o for o in seg if not any(n in o.name for n in NOT_FOLD)]
        stages = sum(args.get("device_ms", {}).get(s, 0.0) for s in STAGES)
        for key in ("final", "all") if args.get("final") else ("all",):
            o = out[key]
            o["folds"] += 1
            o["stages_ms"] += stages
            o["device_ops_ms"] += sum(op.dur_us for op in seg) / 1e3
        if args.get("final"):
            for op in seg:
                name = profile.short_name(op.name)
                by_name[name] = by_name.get(name, 0.0) + op.dur_us / 1e3
    for o in out.values():
        if o["folds"]:
            o["ratio"] = o["stages_ms"] / o["device_ops_ms"]
            for k in ("stages_ms", "device_ops_ms"):
                o[k + "_per_fold"] = o[k] / o["folds"]
    out["final"]["device_ops_ms_by_name"] = by_name
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.obs.trace import get_tracer
    captured = {}
    real = profile.read_trace

    def capture(path):
        captured["ops"], _ = out = real(path)
        return out
    from repro_torch.service import ReconstructionService
    real_fold = ReconstructionService._fold
    tails = []

    def fold(svc, item, tracer):
        t0 = time.perf_counter()
        ended = real_fold(svc, item, tracer)
        if item.final:
            tails.append((item.arrived_at, t0, time.perf_counter()))
        return ended
    ReconstructionService._fold = fold
    profile.read_trace = capture
    try:
        res = cell.run(Registry(ROOT), CELL, args.seed, args.seconds,
                       bool(args.trace))
    finally:
        ReconstructionService._fold = real_fold
        profile.read_trace = real
    out = {"device": torch.cuda.get_device_name(0), "seed": args.seed,
           "correct": res["correct"], "attempted": res["attempted"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "memory_peak_bytes": res["memory_peak_bytes"],
           "ttv_ms": [round(1e3 * t, 3) for _, t in res["timeline"]],
           "lateness": res["lateness"]}
    # each landed scan's tail on the host clock: its last delta's arrival
    # to its fold's start on the serving thread, that fold (with the wait
    # for its volume) to DONE, and DONE to the client's seeing it. The
    # window's final folds are the last ones, in the order the scans were
    # due (set-up's streams fold first).
    window = tails[len(tails) - len(res["timeline"]):]
    out["tails_ms"] = [[round(1e3 * (t0 - a), 3), round(1e3 * (t1 - t0), 3),
                        round(1e3 * (a + ttv - t1), 3)]
                       for (a, t0, t1), (_, ttv) in zip(window,
                                                        res["timeline"])]
    if args.trace:
        events = get_tracer().events()
        out.update(
            busy_share=res["busy_s"] / res["window_s"],
            folds=fold_times(events, captured["ops"]),
            final_folds=final_folds(events),
            breakdown=res["breakdown"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
