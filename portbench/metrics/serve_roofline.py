"""The served field's share of its roofline: the least time of one grid
forward (core/work.grid_forward) over the device ms of every kernel in a
request, whatever implements it."""

from portbench.core import work


def read(ctx):
    ms = ctx.trace.per_unit_ms(lambda rec: True)
    w = work.kernel_work("grid_forward", ctx.config)
    if ms is None or w is None:
        return None
    return 100.0 * work.least_time_s(*w) * 1e3 / ms
