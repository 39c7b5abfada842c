"""stream.delta_wait_ms (ms): the mean time a pushed delta waited, from
its arrival to the start of its fold on the serving thread, over the
window's folds, read from the program's own trace: the ``wait_ms`` arg of
every ``service.stream.fold`` span. Nothing is read where no fold carries
it."""


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    waits = [e["args"]["wait_ms"]
             for e in get_tracer().spans("service.stream.fold")
             if "wait_ms" in e.get("args", {})]
    return sum(waits) / len(waits) if waits else None
