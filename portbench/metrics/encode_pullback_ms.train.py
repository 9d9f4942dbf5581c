"""Device ms a training step in the kernels launched inside the program's
`pat.encode.pullback` spans: the encoder's pull-back (autograd.grad of the
encoding, kernels/mega_ngp and kernels/fit), whose kernels the autograd
engine launches from its own thread. From the stretch traced with host
activity, which alone records the spans; None where they are missing."""

from portbench.core import spans


def read(ctx):
    return spans.device_ms(ctx.host_trace, "pat.encode.pullback")
