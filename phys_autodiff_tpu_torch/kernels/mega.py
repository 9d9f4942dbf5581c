"""K3: the MLP -> residual -> loss mega-kernel (port of
phys_autodiff_tpu/pallas/mega.py; CUDA source csrc/mega.cu).

(L_sigma, L_u) from one kernel pass over the folded MLP tables of K2: the
fields at t-dt, t, t+dt never reach device memory. The kernel writes
per-(z plane, tile) partials that K1's finalize pass adds in the fixed
order of ops.loss.sum_partials. It takes any grid (no VMEM feasibility
gate and no staged fallback, which were TPU constraints).

`mega_loss_pipeline` runs the plain PyTorch version (table MLP -> staged
residuals -> plane partials -> sum_partials) for CPU params and launches
the kernel for CUDA params. It is differentiable in the params and a
tensor t: an autograd.Function whose backward is autograd through the
staged loss (the JAX custom_vjp, pallas/mega.py:553-587). The training
step overrides that backward with K4 (train/slab_grad.make_fused_loss).
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, check_dims, fold_tables, mlp_tables_plain
from phys_autodiff_tpu_torch.kernels.residuals import finalize_partials, num_tiles
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import generate_fields, slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

# z rows a block marches over; each block recomputes one row below and one
# above its range (the TPU kernel carried them across its sequential grid).
ZROWS = 8


def mega_partials_plain(g: GridSpec, ab, cd, w2t, b2) -> torch.Tensor:
    """The plain version of the kernel: plane partials [2, nz]."""
    sigma, u = mlp_tables_plain(ab, cd, w2t, b2)
    fields = FieldSnapshots(sigma[0], sigma[1], sigma[2], u[0], u[1], u[2])
    return ops_loss.plane_partials(*ops_stencil.residuals(g, fields))


def _mega_partials(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2):
    h = ab.shape[0]
    dev = ab.device
    tile_parts = torch.empty((2, g.nz, num_tiles(g)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_partials(
            ab.data_ptr(), cd.data_ptr(), w2t.data_ptr(), b2.data_ptr(), tile_parts.data_ptr(),
            g.nx, g.ny, g.nz, h, ZROWS, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            _build.stream_ptr(dev),
        )
    _build.check(err, "mega kernel")
    _build.LAUNCHES["mega"] += 1
    return finalize_partials(g, w, tile_parts)


def _mega_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str):
    """(L_sigma, L_u) as a [2] tensor: the kernel, or its plain version."""
    _build.check_precision(precision, "K3")
    check_dims(cfg, params)
    tables = fold_tables(g, cfg, params, slice_times(t, g.dt))
    if not _build.uses_kernel(*params.values()):
        return torch.stack(ops_loss.sum_partials(g, w, mega_partials_plain(g, *tables)))
    return _mega_partials(g, w, *tables)[1]


def _staged_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t) -> torch.Tensor:
    """The staged loss [L_sigma, L_u] of the MLP's fields (models.fields ->
    ops.loss): what the backward differentiates."""
    return torch.stack(ops_loss.loss_forward(g, w, generate_fields(g, cfg, params, t, g.dt)))


class _MegaLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w, cfg, precision, t, *weights):
        ctx.g, ctx.w, ctx.cfg, ctx.t = g, w, cfg, t
        ctx.save_for_backward(*weights)
        return _mega_loss(g, w, cfg, dict(zip(_PARAM_KEYS, weights)), t, precision)

    @staticmethod
    def backward(ctx, d_loss):
        t = ctx.t
        t_grad = isinstance(t, torch.Tensor) and ctx.needs_input_grad[4]
        with torch.enable_grad():
            ws = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            tt = t.detach().requires_grad_() if t_grad else t
            loss = _staged_loss(ctx.g, ctx.w, ctx.cfg, dict(zip(_PARAM_KEYS, ws)), tt)
        grads = torch.autograd.grad(loss, ws + ([tt] if t_grad else []), d_loss)
        return (None, None, None, None, grads[4] if t_grad else None, *grads[:4])


def mega_loss_pipeline(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """(L_sigma, L_u) from ONE kernel pass: MLP -> fields (registers and
    shared memory only) -> residuals -> per-plane partials -> fixed-order
    sum. Differentiable (staged backward)."""
    loss = _MegaLoss.apply(g, w, cfg, precision, t, *(params[k] for k in _PARAM_KEYS))
    return loss[0], loss[1]
