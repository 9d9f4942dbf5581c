"""MLP -> physics-field generation (port of phys_autodiff_tpu/models/fields.py).

Grid coords at t-dt, t, t+dt -> one batched MLP evaluation -> split the 4
output channels into sigma [nz,ny,nx] and channel-major u [3,nz,ny,nx].
Plain PyTorch, differentiable by autograd; the device follows the params.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.coords import grid_coords
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots


def slice_times(t, dt):
    """[t - dt, t, t + dt] rounded like the JAX package
    (jnp.float32(t) - jnp.float32(dt), ...).

    A tensor t gives a float32 tensor of tensor ops, so autograd reaches t.
    A Python or numpy t gives float32 host values: a small host-to-device
    copy from pageable memory waits for the device, so kernel wrappers
    fold these in as scalars instead of uploading them."""
    dt32 = np.float32(dt)
    if isinstance(t, torch.Tensor):
        t32 = t.to(torch.float32)
        return torch.stack([t32 - float(dt32), t32, t32 + float(dt32)])
    t32 = np.float32(t)
    return np.array([t32 - dt32, t32, t32 + dt32], dtype=np.float32)


def grid_infer(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t):
    """MLP over the grid at time t -> [nz, ny, nx, Out]."""
    coords = grid_coords(g, t, cfg.norm, device=params["W1"].device)
    return mlp.forward(params, coords)


def split_channels(y: torch.Tensor):
    """[..., nz, ny, nx, 4] -> sigma [..., nz,ny,nx], u [..., 3, nz,ny,nx]."""
    sigma = y[..., 0]
    u = torch.movedim(y[..., 1:4], -1, -4)
    return sigma, u


def generate_fields(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t, dt) -> FieldSnapshots:
    """Fields at t-dt, t, t+dt from one batched MLP evaluation."""
    device = params["W1"].device
    ts = torch.as_tensor(slice_times(t, dt), device=device)
    base = grid_coords(g, 0.0, cfg.norm, device=device)
    spatial = base[..., :3]
    t_off = base[..., 3]  # 0.0 or 0.5 depending on the norm quirk
    coords = torch.cat(
        [
            spatial[None].expand((3,) + spatial.shape),
            (t_off[None] + ts[:, None, None, None])[..., None],
        ],
        dim=-1,
    )
    y = mlp.forward(params, coords)  # [3, nz, ny, nx, 4]
    sigma, u = split_channels(y)
    return FieldSnapshots(
        sigma_tm1=sigma[0],
        sigma_t=sigma[1],
        sigma_tp1=sigma[2],
        u_tm1=u[0],
        u_t=u[1],
        u_tp1=u[2],
    )
