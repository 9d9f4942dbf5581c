"""Device ms a training step in kernels that are neither the program's own
CUDA kernels (csrc/) nor the optimizer's: the folds, the encoder and its
pull-back, the glue. From the stretch traced with host activity, which
says which kernels the optimizer launched."""

OPTIMIZER = "Optimizer.step"


def read(ctx):
    tr = ctx.host_trace
    return tr.per_unit_ms(lambda r: not ctx.is_program_kernel(r) and not tr.launched_under(r, OPTIMIZER))
