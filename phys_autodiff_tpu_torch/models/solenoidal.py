"""Divergence-free-by-construction field models, u = curl A (port of
phys_autodiff_tpu/models/solenoidal.py).

The model's last three output channels are read as a vector potential A and
the velocity the physics sees is the discrete curl u = curl_h A
(ops.projection.velocity_from_potential), which the framework's central
divergence annihilates identically in both boundary modes. Works for every
model family (the 4 output channels are relabelled [sigma, Ax, Ay, Az]) and
trains through the generic training step.

eval_points_solenoidal evaluates the CONTINUOUS curl at arbitrary points by
forward-mode derivatives of the model in the query coordinates
(torch.func.jvp, one tangent an axis, as the JAX package's jax.jvp).
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.ops.projection import velocity_from_potential
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.utils.config import GridSpec


def grid_infer_solenoidal(g: GridSpec, model_cfg, params, t):
    """(sigma [nz, ny, nx], u [3, nz, ny, nx]) with u the discrete curl of
    the model's potential channels: divergence(g, u) is zero to rounding."""
    from phys_autodiff_tpu_torch.models.sample import grid_infer_any

    y = grid_infer_any(g, model_cfg, params, t)
    sigma = y[..., 0]
    pot = torch.movedim(y[..., 1:4], -1, 0)
    return sigma, velocity_from_potential(g, pot)


def generate_fields_solenoidal(g: GridSpec, model_cfg, params, t, dt) -> FieldSnapshots:
    """The six physics inputs at t-dt, t, t+dt, every velocity slice exactly
    divergence-free (drop-in for models.generate_fields). A tensor t stays a
    tensor, so autograd reaches it."""
    if isinstance(t, torch.Tensor):
        t = t.to(torch.float32)
        times = (t - float(np.float32(dt)), t, t + float(np.float32(dt)))
    else:
        t, dt = np.float32(t), np.float32(dt)
        times = (t - dt, t, t + dt)
    outs = [grid_infer_solenoidal(g, model_cfg, params, tt) for tt in times]
    return FieldSnapshots(
        sigma_tm1=outs[0][0],
        sigma_t=outs[1][0],
        sigma_tp1=outs[2][0],
        u_tm1=outs[0][1],
        u_t=outs[1][1],
        u_tp1=outs[2][1],
    )


def make_solenoidal_train_step(g: GridSpec, w, model_cfg, cfg, params0):
    """(step, state0) training the solenoidal head against the physics loss:
    train.make_generic_train_step over generate_fields_solenoidal (any model
    family; gradients flow through the curl's stencil shifts)."""
    from phys_autodiff_tpu_torch.train.loop import make_generic_train_step

    return make_generic_train_step(
        g, w, lambda p, tt: generate_fields_solenoidal(g, model_cfg, p, tt, g.dt), cfg, params0)


def eval_points_solenoidal(g: GridSpec, model_cfg, params, pts_unit: torch.Tensor, t, precision: str = "f32"):
    """(sigma [N], u [N, 3]) at unit-cube points: u is the continuous curl of
    the potential channels, from one forward-mode tangent an axis through
    the model. Unit coord u_a = x_a / ((n_a - 1) h_a), so
    d/dx_a = d/du_a / ((n_a - 1) h_a). Differentiable in the params."""
    from phys_autodiff_tpu_torch.models.sample import evaluate_points

    pts_unit = pts_unit.to(torch.float32)
    inv_h = [1.0 / (max(g.nx - 1, 1) * g.hx), 1.0 / (max(g.ny - 1, 1) * g.hy), 1.0 / (max(g.nz - 1, 1) * g.hz)]

    def eval_batched(pu):  # [N, 3] -> [N, 4]
        return evaluate_points(model_cfg, params, pu, t, precision)

    y = None
    dA = []  # dA[a][:, c] = dA_c / dx_a
    for a in range(3):
        tang = torch.zeros_like(pts_unit)
        tang[:, a] = 1.0
        primal, jv = torch.func.jvp(eval_batched, (pts_unit,), (tang,))
        if y is None:
            y = primal
        dA.append(jv[:, 1:4] * float(np.float32(inv_h[a])))
    u = torch.stack(
        [
            dA[1][:, 2] - dA[2][:, 1],  # dAz/dy - dAy/dz
            dA[2][:, 0] - dA[0][:, 2],  # dAx/dz - dAz/dx
            dA[0][:, 1] - dA[1][:, 0],  # dAy/dx - dAx/dy
        ],
        dim=-1,
    )
    return y[:, 0], u
