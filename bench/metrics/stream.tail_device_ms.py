"""stream.tail_device_ms (ms): the device's part of a stream's time to
volume, read from the program's own trace of the window: over the
``session.fold`` spans of the folds that finished a stream (``final``
true), the mean of their device stages (``device_ms``): the last delta's
filter kernel (``filter.kernel``, its launch alone, on a card), its
back-projection (``stage.backproject``), its add into the accumulator
(``stream.accumulate``) and the epilogue (``stream.finalize``). Nothing is
read where no such span carries stage times."""

STAGES = ("filter.kernel", "stage.backproject", "stream.accumulate",
          "stream.finalize")


def read(ctx):
    from repro_torch.obs.trace import get_tracer
    tails = [sum(e["args"]["device_ms"].get(s, 0.0) for s in STAGES)
             for e in get_tracer().spans("session.fold")
             if e.get("args", {}).get("final")
             and "device_ms" in e["args"]]
    return sum(tails) / len(tails) if tails else None
