"""The arithmetic the reference runs in.

REFERENCE is float64 throughout. CONTROL is the step below the float32
that the configurations state (with TF32 off): float32 with every matmul's
operands rounded to TF32 (10 explicit mantissa bits) and summed in
float32, what `torch.backends.cuda.matmul.allow_tf32 = True` runs on the
card. The rounding is written out, so the control gives the same numbers
on the CPU as on the card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool = False


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, tf32=True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b on TF32-rounded operands with float32 sums, and its pull-back
    the same way (the card runs the backward's matmuls in TF32 too)."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, gy):
        ar, br = ctx.saved_tensors
        gr = round_tf32(gy)
        da = gr @ br.T
        db = ar.reshape(-1, ar.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """a [..., K] @ b [K, N] in the arithmetic of `prec`."""
    if prec.tf32:
        return _Tf32Matmul.apply(a, b)
    return a @ b
