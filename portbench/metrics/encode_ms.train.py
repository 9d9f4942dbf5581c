"""Device ms a training step in the kernels launched inside the program's
`pat.encode` spans: the hash encoder's forward
(models/hash_encoder.encode_grid_zcf). From the stretch traced with host
activity, which alone records the spans; None where they are missing."""

from portbench.core import spans


def read(ctx):
    return spans.device_ms(ctx.host_trace, "pat.encode")
