"""service.queue_wait_ms (ms): the mean time a scan waited from its
arrival to the start of its bucket, over the scans of the window's
buckets, read from the program's own trace: the ``queue_ms`` arg of every
``service.bucket`` span. Nothing is read where no bucket carries it."""


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    waits = [q for e in get_tracer().spans("service.bucket")
             if e["name"] == "service.bucket"
             for q in e.get("args", {}).get("queue_ms", ()) if q is not None]
    return sum(waits) / len(waits) if waits else None
