"""Grid coordinate generation (port of phys_autodiff_tpu/models/coords.py).

Same quirks as the reference's make_grid_coords:
  * spatial: v / (n - 1) in [0, 1]; MinusOneToOne maps to 2u - 1
  * degenerate axes (n <= 1) produce coordinate 0
  * time channel: raw t for MinusOneToOne, but t + 0.5 for ZeroToOne

Output layout: [nz, ny, nx, 4] with channels (x, y, z, t).
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import CoordNorm, GridSpec


def _axis_coord(n: int, norm: CoordNorm, device=None) -> torch.Tensor:
    if n <= 1:
        return torch.zeros((max(n, 1),), dtype=torch.float32, device=device)
    u = torch.arange(n, dtype=torch.float32, device=device) / float(np.float32(n - 1))
    if norm == CoordNorm.MinusOneToOne:
        return 2.0 * u - 1.0
    return u


def time_offset(norm: CoordNorm) -> float:
    """The t-channel offset: 0 for MinusOneToOne, 0.5 for ZeroToOne."""
    return 0.0 if norm == CoordNorm.MinusOneToOne else 0.5


def grid_coords(g: GridSpec, t, norm: CoordNorm = CoordNorm.MinusOneToOne, device="cuda"):
    """Coordinates [nz, ny, nx, 4] on `device` (the card unless the caller
    asks for the CPU). `t` is a float or a 0-d float32 tensor."""
    cx = _axis_coord(g.nx, norm, device)
    cy = _axis_coord(g.ny, norm, device)
    cz = _axis_coord(g.nz, norm, device)
    shape = g.shape
    xs = cx[None, None, :].expand(shape)
    ys = cy[:, None].expand(shape)
    zs = cz[:, None, None].expand(shape)
    t_val = torch.as_tensor(t, dtype=torch.float32, device=device)
    if norm != CoordNorm.MinusOneToOne:
        t_val = t_val + 0.5
    ts = t_val.expand(shape)
    return torch.stack([xs, ys, zs, ts], dim=-1)
