"""The whole unit's share of the card's FP32 peak: the least operations of
one unit (core/work.unit_flops: a step's kernels, the encoder's and the
optimizer's work; or a served field) times the units of the traced
window, over the window's seconds times 67 TFLOP/s."""

from portbench.core import work


def read(ctx):
    flops = work.unit_flops(ctx.traffic["loop"], ctx.config)
    if flops is None or not ctx.trace.window_s:
        return None
    return 100.0 * flops * ctx.window.units / (ctx.trace.window_s * work.PEAK_FLOPS_F32)
