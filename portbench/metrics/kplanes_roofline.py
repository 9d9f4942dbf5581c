"""The K-Planes step's share of its roofline: the least time of the encoder
pair and K5 on the three slices' encodings (families/kplanes.kplanes_work:
the head's and the encoding's least operations, whatever the split) over
the device ms a step of the kernels they launch: csrc/kplanes_encode.cu
(the forward inside `pat.encode`, the pull-back inside
`pat.encode.pullback`) and csrc/mega_ngp.cu's pat_mega_ngp_kplanes. None
where the trace has none of them."""

from portbench.core import work

KERNELS = ("k_kp_nodes", "k_kp_encode", "k_kp_pull_main", "k_kp_pull_sum", "k_kp_unsample", "k_kp_fields",
           "k_residuals", "k_kp_adjoint", "k_kp_denc", "k_sum_parts")


def read(ctx):
    ms = ctx.trace.per_unit_ms(ctx.kernels_named(KERNELS))
    w = work.kernel_work("kplanes", ctx.config)
    if ms is None or w is None:
        return None
    return 100.0 * work.least_time_s(*w) * 1e3 / ms
