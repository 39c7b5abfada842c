"""plan.relayout_device_ms (ms): device time per lane run of what moves
data around the back-projection kernel rather than filtering or
back-projecting it, read from the program's own trace of the window: the
``bp.operands`` (the Q^T relayout and parameter rows), ``bp.unfold`` (the
dual slab restored) and ``stage.reduce`` (the FDK scale and the lane's
store) device stages (obs.trace.device_stage) that every ``engine.batched``
span carries in its ``device_ms`` arg, over the span's ``lanes``. Nothing
is read where the engine spans carry no stage times."""

STAGES = ("bp.operands", "bp.unfold", "stage.reduce")


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    ms = lanes = 0
    for e in get_tracer().spans("engine.batched"):
        args = e.get("args", {})
        if "device_ms" in args and args.get("lanes"):
            ms += sum(args["device_ms"].get(s, 0.0) for s in STAGES)
            lanes += args["lanes"]
    return ms / lanes if lanes else None
