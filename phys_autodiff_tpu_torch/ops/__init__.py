"""Staged residual and loss ops in plain PyTorch (the kernels' referee), and
the fluid ops of the Euler solver: diagnostics, projection, diffusion,
obstacles (CG solves in cg)."""

from phys_autodiff_tpu_torch.ops import diagnostics, diffusion, obstacles, projection
from phys_autodiff_tpu_torch.ops.loss import (
    loss_backward,
    loss_forward,
    loss_forward_f64,
    loss_forward_planewise,
    loss_terms,
    plane_partials,
    sum_partials,
    total_loss,
)
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots, central_diff, residuals, shift

__all__ = [
    "FieldSnapshots",
    "diagnostics",
    "diffusion",
    "obstacles",
    "projection",
    "residuals",
    "shift",
    "central_diff",
    "loss_terms",
    "loss_forward",
    "total_loss",
    "loss_forward_f64",
    "plane_partials",
    "sum_partials",
    "loss_forward_planewise",
    "loss_backward",
]
