"""device.idle_share: 1 − (union of the device's activity intervals) /
(the traced window's wall time), in %."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
