"""K5's share of its roofline: K5's least time (core/work.k5) over the
device ms a step of the kernels that ngp_loss_and_grad launches from
csrc/mega_ngp.cu."""

from portbench.core import work

KERNELS = ("k_ngp_fields", "k_residuals", "k_ngp_adjoint", "k_sum_parts")


def read(ctx):
    ms = ctx.trace.per_unit_ms(ctx.kernels_named(KERNELS))
    w = work.kernel_work("K5", ctx.config)
    if ms is None or w is None:
        return None
    return 100.0 * work.least_time_s(*w) * 1e3 / ms
