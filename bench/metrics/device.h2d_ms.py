"""device.h2d_ms (ms): device time of host to card copies per scan."""


def read(ctx):
    h2d = ctx.device_seconds("gpu_memcpy", "HtoD")
    if not h2d or not ctx.scans:
        return None
    return 1e3 * h2d / ctx.scans
