"""Host ms a training step: the median length of the program's `pat.step`
spans, the step's whole call as the host runs it ahead of the device
(a launch that finds the device's queue full waits inside it). From the
stretch traced with host activity, which alone records the spans; None
where they are missing."""

from portbench.core import spans


def read(ctx):
    return spans.step_host_ms(ctx.host_trace)
