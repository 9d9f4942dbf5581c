"""Kernel timing on the card with CUDA events and the profiler, and
profiler traces.

The counterpart of phys_autodiff_tpu/utils/timing.py. `trace(log_dir)`
records a torch.profiler trace (the host's ops and, once CUDA is in use,
the card's kernels) and writes it as a Chrome / Perfetto JSON file;
`annotate(name, id)` labels a scope in any profiler's trace (a span) and
costs one check of the profiler's state where none runs. On a CUDA device the
host returns before the kernels finish, so each call is bracketed by a pair
of CUDA events on the current stream; the reported time is the median over
`iters` calls after `warmup` untimed calls. There is no CPU fallback: a
device time exists only where there is a device.

`device_time_ms` splits a call's device time by kernel from a torch.profiler
trace. The profiler may drop records (one trace of ten calls lost a third
of a kernel's launches), so a kernel's time per launch is its total over
the records the trace kept, each kernel's record count comes back beside
it, and a turn whose counts are not its launches a call times the calls is
flagged (`dropped`) and, in `device_time_turn`, repeated once.
"""

from __future__ import annotations

import contextlib
import math
import os
import statistics
import time
from dataclasses import dataclass

import torch


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of `fn()` in milliseconds (CUDA events)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


@dataclass(frozen=True)
class KernelTime:
    """One kernel's device time in a trace of `calls` calls: `ms` a launch
    (its total over the `count` records the trace kept) and `per_call`,
    its launches a call (the larger of a one-call trace's count and
    count / calls rounded up: a dropped record only lowers either)."""

    ms: float
    count: int
    per_call: int

    @property
    def call_ms(self) -> float:
        """Device time a call: ms a launch times the launches a call."""
        return self.ms * self.per_call


def _kernel_records(fn, calls: int) -> dict[str, tuple[float, int]]:
    """(total device us, record count) of each CUDA kernel in a trace of
    `calls` calls of fn(). Ranges that the profiler mirrors onto the device
    timeline (user annotations such as torch.optim's
    `Optimizer.step#Adam.step`) span kernels already counted, so they are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: (e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    }


def device_time_ms(fn, calls: int = 10) -> dict[str, KernelTime]:
    """Device time of each CUDA kernel that `fn()` launches, by kernel
    name: a warm-up call, a one-call trace (the launches a call), then a
    trace of `calls` calls (the times). Unlike cuda_time_ms this excludes
    the gaps in which the device waits for the host. Empty if the profiler
    saw no device work."""
    fn()
    torch.cuda.synchronize()
    once = _kernel_records(fn, 1)
    out = {}
    for key, (total_us, count) in _kernel_records(fn, calls).items():
        per_call = max(once.get(key, (0.0, 0))[1], math.ceil(count / calls))
        out[key] = KernelTime(total_us / count / 1e3, count, per_call)
    for key in once.keys() - out.keys():  # every record of a kernel lost
        out[key] = KernelTime(once[key][0] / once[key][1] / 1e3, 0, once[key][1])
    return out


def call_ms(times: dict[str, KernelTime]) -> float:
    """Device time a call, summed over the kernels."""
    return sum(t.call_ms for t in times.values())


def dropped(times: dict[str, KernelTime], calls: int = 10) -> list[str]:
    """The kernels whose record count in a trace of `calls` calls differs
    from their launches a call times the calls (records the profiler lost,
    or a call whose launches vary)."""
    return sorted(k for k, t in times.items() if t.count != t.per_call * calls)


def device_time_turn(fn, calls: int = 10, what: str = "", log=print) -> tuple[dict[str, KernelTime], list[str]]:
    """device_time_ms, repeated once if the turn lost records: (the times
    of the last turn, the kernels still flagged in it). Each flagged turn
    is logged."""
    for turn in range(2):
        times = device_time_ms(fn, calls)
        bad = dropped(times, calls)
        if not bad:
            return times, bad
        lost = ", ".join(f"{k[:48]} {times[k].count} of {times[k].per_call * calls}" for k in bad)
        log(f"device_time {what}: the profiler kept fewer records than launches ({lost})"
            + ("; repeating the turn" if turn == 0 else "; flagged"))
    return times, bad


@dataclass
class Trace:
    """A `trace` in progress: the profiler, and the file it was written to
    (set when the context exits)."""

    prof: object
    path: str | None = None


@contextlib.contextmanager
def trace(log_dir: str, perfetto: bool = False):
    """Record a torch.profiler trace of the enclosed code and write it into
    log_dir as a Chrome / Perfetto JSON trace (`trace_<pid>_<ns>.json`,
    gzipped as `.json.gz` when perfetto=True; both open in Perfetto and
    chrome://tracing). It records the host's activity with each op's
    inputs (an `annotate` span's id among them) and, once CUDA is
    initialised in this process (a CUDA tensor or device is in use), the
    card's kernels. Yields a Trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(profile(activities=activities, record_shapes=True))
    out.prof.start()
    try:
        yield out
    finally:  # written also when the body raises, as jax.profiler's trace is
        if cuda:
            torch.cuda.synchronize()
        out.prof.stop()
        name = f"trace_{os.getpid()}_{time.time_ns()}.json" + (".gz" if perfetto else "")
        out.path = os.path.join(log_dir, name)
        out.prof.export_chrome_trace(out.path)


class _Span:
    """A profiler range (a user annotation) from enter to exit; `args`, the
    span's id or nothing, are its recorded inputs ("Concrete Inputs" in the
    exported trace of a profiler that records them)."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, id: int | None = None):
    """A named scope that shows up in the traces of any running
    torch.profiler (a user annotation on the host's timeline; the kernels
    launched inside it are found by their correlation ids), with `id` (a
    step's index) as its input. Where no profiler runs it is one shared
    no-op context: a check of the profiler's state, nothing recorded."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name, () if id is None else (id,))
