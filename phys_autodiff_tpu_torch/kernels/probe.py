"""P1: the per-launch floor probe (port of bound_min_call,
scripts/small_grid_experiments.py:34; CUDA source csrc/probe.cu).

out = x + 1 over one [py, px] float32 plane. The work is negligible, so its
time on the card is the least any launch of the port costs: chip_smoke.py
sets it beside the kernels whose bound is a few microseconds. No user path
runs it.
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.kernels import _build


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """x + 1; the kernel for a CUDA tensor, the plain version for a CPU one."""
    x = x.contiguous()
    if not _build.uses_kernel(x):
        return probe_plain(x)
    out = torch.empty_like(x)
    dev = x.device
    with torch.cuda.device(dev):
        err = _build.lib().pat_probe(x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_ptr(dev))
    _build.check(err, "probe kernel")
    _build.LAUNCHES["probe"] += 1
    return out
