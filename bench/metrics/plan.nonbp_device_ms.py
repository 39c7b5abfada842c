"""plan.nonbp_device_ms (ms): device time per scan of every kernel, copy
and fill other than the back-projection kernels
(bench/roofline/names/backproject/): the filter (cuFFT), the codec, the
kernel's operand layout, the stack and the scale."""


def read(ctx):
    if not ctx.scans or not ctx.ops:
        return None
    rest = ctx.device_seconds() - ctx.kernel_seconds("backproject")
    return 1e3 * rest / ctx.scans
