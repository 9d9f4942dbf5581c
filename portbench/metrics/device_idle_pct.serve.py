"""The share of the traced window in which no operation runs on the
device: one less the union of the device records over the window."""


def read(ctx):
    busy, window = ctx.trace.busy_s(), ctx.trace.window_s
    if not window or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
