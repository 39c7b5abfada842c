"""device.idle_share (%): the share of the traced window in which no
kernel, copy or fill ran on the device."""


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
