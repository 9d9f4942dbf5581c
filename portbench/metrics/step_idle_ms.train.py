"""Device-idle ms a training step: the median over the program's `pat.step`
spans of the idle gaps whose middle lies inside the span, the idle that
the program's host path leaves, not the drain at the benchmark's loss
read (core/spans.step_idle_ms). From the stretch traced with host
activity, which alone records the spans; None where they are missing."""

from portbench.core import spans


def read(ctx):
    return spans.step_idle_ms(ctx.host_trace)
