"""Kernel timing on the card with CUDA events.

The counterpart of phys_autodiff_tpu/utils/timing.py. On a CUDA device the
host returns before the kernels finish, so each call is bracketed by a pair
of CUDA events on the current stream; the reported time is the median over
`iters` calls after `warmup` untimed calls. There is no CPU fallback: a
device time exists only where there is a device.
"""

from __future__ import annotations

import statistics

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


def device_time_ms(fn, calls: int = 10) -> dict[str, float]:
    """Per-call device time (ms) of each CUDA kernel that `fn()` launches,
    by kernel name, from a torch.profiler trace of `calls` calls after one
    warm-up call. Unlike cuda_time_ms this excludes the gaps in which the
    device waits for the host. Empty if the profiler saw no device work.
    Ranges that the profiler mirrors onto the device timeline (user
    annotations such as torch.optim's `Optimizer.step#Adam.step`) span
    kernels already counted, so they are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {
        e.key: e.self_device_time_total / calls / 1e3
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    }
