"""backproject_roofline (%): the least time one scan's back-projection can
take on this device (bench/roofline/backproject.py's frozen count against
the peaks of bench/roofline/peaks.json) over the device time per scan of
the kernels bench/roofline/names/backproject/ lists. Nothing is read where
those kernels did not run or the device has no peaks in the table."""


def read(ctx):
    kernel_s = ctx.kernel_seconds("backproject")
    if not kernel_s or not ctx.scans or ctx.peak is None:
        return None
    bound = ctx.registry.kernel_count("backproject").bound_seconds(
        ctx.geometry, ctx.wire_itemsize, ctx.peak, ctx.device)
    return 100.0 * bound["seconds"] / (kernel_s / ctx.scans)
