"""Staged residual and loss ops in plain PyTorch (the kernels' referee)."""

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
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots, residuals

__all__ = [
    "FieldSnapshots",
    "residuals",
    "loss_terms",
    "loss_forward",
    "total_loss",
    "loss_forward_f64",
    "plane_partials",
    "sum_partials",
    "loss_forward_planewise",
    "loss_backward",
]
