"""K4's share of its roofline: K4's least time (core/work.k4) over the
device ms a step of the kernels that mega_loss_and_grad launches from
csrc/mega_bwd.cu."""

from portbench.core import work

KERNELS = ("k_bwd_fields", "k_residuals", "k_bwd_adjoint", "k_bwd_finalize", "k_bwd_reduce")


def read(ctx):
    ms = ctx.trace.per_unit_ms(ctx.kernels_named(KERNELS))
    w = work.kernel_work("K4", ctx.config)
    if ms is None or w is None:
        return None
    return 100.0 * work.least_time_s(*w) * 1e3 / ms
