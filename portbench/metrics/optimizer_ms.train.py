"""Device ms a training step in the kernels torch.optim launches (those
launched inside its "Optimizer.step#..." range), from the stretch traced
with host activity: a kernel's device time is its own there, while the
host's records slow only the host."""

OPTIMIZER = "Optimizer.step"


def read(ctx):
    tr = ctx.host_trace
    return tr.per_unit_ms(lambda r: tr.launched_under(r, OPTIMIZER))
