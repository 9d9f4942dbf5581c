"""The fused training loss (port of make_fused_loss,
phys_autodiff_tpu/train/slab_grad.py:189-279).

`make_fused_loss(...)(params, t)` is the scalar loss L_sigma + L_u with a
fused path in both directions: the forward is the MLP -> residual -> loss
mega-kernel K3 (kernels/mega.py), the backward the backward mega-kernel K4
(kernels/mega_bwd.py), whose gradients the autograd.Function scales by the
cotangent. On CPU params both run their plain versions.

The JAX module's slab-recompute gradient (make_slab_loss_and_grad,
make_slab_raw, pick_slab_rows, with ops.stencil.residuals_zext) is the
TPU's fallback where the backward kernel's VMEM runs out. K4 on the card
takes every grid at H <= 1300, and K3 every H that K4 takes (H <= 1908),
so it is not ported yet (ROADMAP.md A13).
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels.mega import mega_loss_pipeline
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_loss_and_grad
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS
from phys_autodiff_tpu_torch.models import mlp


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w, cfg, precision, t, *weights):
        ctx.args = (g, w, cfg, precision, t)
        ctx.save_for_backward(*weights)
        ls, lu = mega_loss_pipeline(g, w, cfg, dict(zip(_PARAM_KEYS, weights)), t, precision)
        return ls + lu

    @staticmethod
    def backward(ctx, ct):
        g, w, cfg, precision, t = ctx.args
        params = dict(zip(_PARAM_KEYS, ctx.saved_tensors))
        _, (gp, gt) = mega_loss_and_grad(g, w, cfg, params, t, precision)
        d_t = ct * gt.to(t.device) if isinstance(t, torch.Tensor) and ctx.needs_input_grad[4] else None
        return (None, None, None, None, d_t, *(ct * gp[k] for k in _PARAM_KEYS))


def make_fused_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, precision: str = "f32"):
    """Returns loss(params, t) -> scalar tensor: K3 forward, K4 backward."""

    def loss(params: mlp.Params, t):
        return _FusedLoss.apply(g, w, cfg, precision, t, *(params[k] for k in _PARAM_KEYS))

    return loss
