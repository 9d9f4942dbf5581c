"""Error metrics used by the parity-test ladder (the port's own copy of
phys_autodiff_tpu/utils/metrics.py).

Same definitions as the reference's helpers
(test/test_phys_cuda_nonfused_vs_cpu.cpp:13-27): relative L2 error with a
1e-30 denominator guard, and max absolute error. Computed in float64.
"""

from __future__ import annotations

import numpy as np


def rel_l2_err(a, b) -> float:
    """sqrt(sum((a-b)^2) / (sum(b^2) + 1e-30)); b is the reference."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    num = np.sum((a - b) ** 2)
    den = np.sum(b**2) + 1e-30
    return float(np.sqrt(num / den))


def max_abs_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)))
