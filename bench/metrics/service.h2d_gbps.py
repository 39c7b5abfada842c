"""service.h2d_gbps (GB/s): the rate of the serving thread's lane copies
to the device, read from the program's own trace of the window: the bytes
over the seconds of every ``service.lane.h2d`` span whose scan came from
host memory (``src`` "host"). A span is host time, so the rate is at most
the device's own copy rate. Nothing is read where no lane was copied."""


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    nbytes = us = 0
    for e in get_tracer().spans("service.lane.h2d"):
        args = e.get("args", {})
        if args.get("src") == "host":
            nbytes += args["bytes"]
            us += e["dur"]
    return nbytes / (us * 1e3) if nbytes and us else None
