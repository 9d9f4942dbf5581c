"""Host ms a request, from the call until it returns (before the
synchronise that ends the request): the median over the traced requests,
on the benchmark's own clock."""

import statistics


def read(ctx):
    if not ctx.window.host_s:
        return None
    return 1e3 * statistics.median(ctx.window.host_s)
