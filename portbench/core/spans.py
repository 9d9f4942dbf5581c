"""The program's spans in the stretch traced with host activity, and what
the per-layer metrics read from them.

The port opens its spans with utils/timing.annotate: host ranges named
`pat.step` (a training step, its index as its input), `pat.fold` and
`pat.fold.pullback` (the MLP's folds and their pull-back), `pat.encode`
and `pat.encode.pullback` (the hash encoder and its pull-back). They are
recorded only where the profiler records host activity.

A kernel belongs to a span when the host call that launched it (found
through its correlation id) lies inside the span's interval on any
thread: on the card the autograd engine launches a pull-back's kernels
from its own device thread while the calling thread waits inside the
span in autograd.grad, and the port runs no other host thread that
launches work meanwhile. A kernel's device ms a step follow core/trace:
its total over its records, times its records over the steps rounded up.
"""

from __future__ import annotations

import statistics

from portbench.core.trace import CUDA_API, HOST_CATS

STEP = "pat.step"
#: Runtime calls that return only once the device has done the work before
#: them (cudaMemcpy is the synchronous copy; cudaMemcpyAsync is not here).
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"})


def spans(tr, name: str) -> list:
    """The host ranges named `name`, in time order."""
    return sorted((r for r in tr.records if r.name == name and r.cat in HOST_CATS), key=lambda r: r.ts)


def _inside(ts: float, ranges) -> bool:
    return any(r.ts <= ts <= r.end for r in ranges)


def device_ms(tr, *names: str) -> float | None:
    """Device ms a step of the kernels launched inside a span of any of
    `names`; None where the trace holds no such span or no such kernel."""
    ranges = [s for n in names for s in spans(tr, n)]
    if not ranges:
        return None

    def launched_inside(rec) -> bool:
        call = tr.launch.get(rec.corr)
        return call is not None and _inside(call.ts, ranges)

    return tr.per_unit_ms(launched_inside)


def step_host_ms(tr) -> float | None:
    """The median host ms of a `pat.step` span."""
    steps = spans(tr, STEP)
    return statistics.median(s.dur for s in steps) / 1e3 if steps else None


def step_waits(tr) -> float | None:
    """Host calls a step, inside `pat.step` spans, that block until the
    device is done (BLOCKING)."""
    steps = spans(tr, STEP)
    if not steps:
        return None
    calls = [r for r in tr.records if r.cat.startswith(CUDA_API) and r.name in BLOCKING and _inside(r.ts, steps)]
    return len(calls) / len(steps)


def step_idle_ms(tr) -> float | None:
    """Device-idle ms a step: the median over the `pat.step` spans of the
    stretch's idle gaps whose middle lies inside the span. That is the idle
    the program's host path leaves, not the drain at the benchmark's loss
    read, which lies outside; the median, since the stretch's first step
    carries the profiler's start (its first launch waits 1-5 ms on the card)."""
    steps = spans(tr, STEP)
    if not steps:
        return None
    lo, hi = tr._span()
    edges = [lo] + [x for iv in tr.busy_intervals() for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return statistics.median(sum(b - a for a, b in gaps if s.ts <= 0.5 * (a + b) <= s.end) for s in steps) / 1e3
