"""Host calls a training step, inside the program's `pat.step` spans, that
block until the device is done (core/spans.BLOCKING); the benchmark's loss
read lies outside them. From the stretch traced with host activity, which
alone records the spans; None where they are missing."""

from portbench.core import spans


def read(ctx):
    return spans.step_waits(ctx.host_trace)
