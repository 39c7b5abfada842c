"""plan.filter_device_ms (ms): device time of the ramp filter and the
codec per lane run, read from the program's own trace of the window: the
``stage.filter`` device stage (obs.trace.device_stage) that every
``engine.batched`` span carries in its ``device_ms`` arg, over the span's
``lanes`` (scans served and pad lanes). Nothing is read where the engine
spans carry no stage times."""

STAGES = ("stage.filter",)


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    ms = lanes = 0
    for e in get_tracer().spans("engine.batched"):
        args = e.get("args", {})
        if "device_ms" in args and args.get("lanes"):
            ms += sum(args["device_ms"].get(s, 0.0) for s in STAGES)
            lanes += args["lanes"]
    return ms / lanes if lanes else None
