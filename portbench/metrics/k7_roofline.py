"""K7's share of its roofline: K7's least time (core/work.k7) over the
device ms a step of the kernels that ngp_fit_loss_and_grad launches from
csrc/fit_ngp.cu."""

from portbench.core import work

KERNELS = ("k_ngp_fit", "k_sum_parts")


def read(ctx):
    ms = ctx.trace.per_unit_ms(ctx.kernels_named(KERNELS))
    w = work.kernel_work("K7", ctx.config)
    if ms is None or w is None:
        return None
    return 100.0 * work.least_time_s(*w) * 1e3 / ms
