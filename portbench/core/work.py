"""The yardstick: the least work of each kernel and step, and the card's
peaks.

Counts are a frozen copy of chip_smoke.py's `work` (the port's per-kernel
least operations and compulsory bytes, csrc headers named there): the
kernels' formulas here, and what a model family's step runs of them in
its families/<family>.py. Float32, each input read once and each output
written once, an FMA counted as two operations. A least time is the
larger of bytes / peak bandwidth and operations / peak FP32 rate. These
are the work the mathematics needs, whatever implements it, so no kernel
that replaces one can push a share of them past 100%.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at 700 W): 67 TFLOP/s FP32
outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from portbench.core import specs
from portbench.reference.ngp import resolutions

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: Operations a cell of the residual (stencil.cuh cell_residual) and of its
#: adjoint (adjoint.cuh).
RES_OPS, ADJ_OPS = 66, 250
#: Operations of one Adam update of one parameter: the two moments (3 and
#: 4), the denominator (3), the update (2).
ADAM_OPS = 12


def least_time_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32)


def k4(nz: int, ny: int, nx: int, h: int) -> tuple[float, float]:
    """K4, the MLP's backward mega-kernel (csrc/mega_bwd.cu): the folded
    tables AB [H, ny, nx], CD [nz, H, 3], W2 and b2 read, their gradients
    written; per cell the three slices' forward (30 H), the head's backward
    (46 H), the residual and its adjoint."""
    n = nz * ny * nx
    tables = h * ny * nx + nz * h * 3 + 5 * h
    return 4 * (2 * tables + 2), (76 * h + RES_OPS + ADJ_OPS) * n


def _head_words(lf: int, hn: int) -> int:
    return 2 * ((lf + 1) * hn + 5 * hn + 4)


def k5(nz: int, ny: int, nx: int, lf: int, hn: int) -> tuple[float, float]:
    """K5, the NGP backward mega-kernel (csrc/mega_ngp.cu): the encoding
    read and its cotangent written, the head and its gradients; per cell
    the base 2 LF H, three slices' layer 2 30 H, the backward 41 H, dW1
    and dEnc 2 LF H each, the residual and its adjoint."""
    n = nz * ny * nx
    return 4 * (2 * lf * n + _head_words(lf, hn) + 3 + 2), (6 * lf * hn + 71 * hn + RES_OPS + ADJ_OPS) * n


def k7(nz: int, ny: int, nx: int, lf: int, hn: int) -> tuple[float, float]:
    """K7, the NGP fit kernel (csrc/fit_ngp.cu): the encoding and the
    target read, the encoding's cotangent written; per cell the forward
    2 LF H + 10 H, the backward 18 H, dW1 and dEnc 2 LF H each, and 23 for
    the error, its squares and db2."""
    n = nz * ny * nx
    return 4 * ((2 * lf + 4) * n + _head_words(lf, hn) + 1 + 2), (6 * lf * hn + 28 * hn + 23) * n


def grid_forward(nz: int, ny: int, nx: int, h: int) -> tuple[float, float]:
    """One field of the coordinate MLP on the grid: layer 1 folds into a
    plane table and a row table (grid coordinates are separable), so a
    cell costs an add, a max and 4 FMA a hidden unit (10 H); the 4 outputs
    written (16 B)."""
    n = nz * ny * nx
    return 16 * n, 10 * h * n


def folds(nz: int, ny: int, nx: int, h: int) -> float:
    """The MLP's layer-1 fold and its pull-back (kernels/mlp.fold_tables):
    AB [H, ny, nx] 4 a value and 4 back, CD [nz, H, 3] 4 a value and 6
    back."""
    return 8 * h * ny * nx + 10 * 3 * nz * h


def encoder(nz: int, ny: int, nx: int, enc: dict) -> float:
    """The hash encoding on the grid and its pull-back: per level the
    separable interpolation, z (on the lattice's planes), then y, then x,
    3 operations an output value (a lerp), and its transpose 4 (two FMA)."""
    f = enc["features_per_level"]
    outputs = sum(f * ((r + 1) ** 2 * nz + (r + 1) * ny * nz + nx * ny * nz) for r in resolutions(enc))
    return 7.0 * outputs


def grid_shape(config: dict) -> tuple[int, int, int]:
    g = config["grid"]
    return g["nz"], g["ny"], g["nx"]


def params_count(config: dict) -> int:
    """The model's parameters (its family's count)."""
    return specs.family(config["family"]).params_count(config)


def kernel_work(kernel: str, config: dict) -> tuple[float, float] | None:
    """(bytes, operations) of one launch of `kernel` ("K4", "K5", "K7",
    "grid_forward") at the configuration's sizes, or None where that
    kernel does not run this configuration (its family's count, from the
    formulas above)."""
    return specs.family(config["family"]).kernel_work(kernel, config)


def unit_flops(loop: str, config: dict) -> float | None:
    """The least FP32 operations of one unit of work of the loop `loop`: a
    training step ("train"), a fitting step ("fit"), each with Adam over
    every parameter, or a served field ("serve"); None where no count is
    kept (its family's count)."""
    return specs.family(config["family"]).unit_flops(loop, config)
