"""Device kernels launched a training step, counted from the trace."""


def read(ctx):
    return ctx.trace.launches_per_unit()
