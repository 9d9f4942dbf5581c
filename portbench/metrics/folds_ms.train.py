"""Device ms a training step in the kernels launched inside the program's
`pat.fold` and `pat.fold.pullback` spans: K4's folded tables and their
pull-back to the MLP's parameters (kernels/mega_bwd). From the stretch
traced with host activity, which alone records the spans; None where they
are missing."""

from portbench.core import spans


def read(ctx):
    return spans.device_ms(ctx.host_trace, "pat.fold", "pat.fold.pullback")
