"""Solid obstacles for the Euler solver: masked no-slip and the masked
projection (port of phys_autodiff_tpu/ops/obstacles.py).

A FLUID MASK m: [nz, ny, nx] float32 in {0, 1} (1 = fluid, 0 = solid) on the
cell-centred grid.

  * box_mask, sphere_mask, union, complement: mask builders (numpy, then a
    tensor on the requested device);
  * apply_no_slip(u, m): zero the velocity inside solids (solid cells are
    then exact fixed points of the semi-Lagrangian step);
  * project_masked(g, u, m, ...): minimize_p || M D (u_s - M_v G p) ||^2,
    u_s = M_v u, by CGNR as ops.projection.project_cg (A^T the VJP of the
    masked operator); the correction is zero in solids, so no-slip
    survives the projection.

Masks are multiplies, so everything is differentiable by autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.ops.diagnostics import divergence
from phys_autodiff_tpu_torch.ops.projection import grad, normal_solve
from phys_autodiff_tpu_torch.utils.config import GridSpec

# ----------------------------------------------------------------- masks


def box_mask(g: GridSpec, lo, hi, device="cuda") -> torch.Tensor:
    """Fluid mask with a solid axis-aligned box of cell-index extents
    [lo, hi) per axis, z-y-x order: lo=(z0,y0,x0), hi=(z1,y1,x1)."""
    m = np.ones(g.shape, np.float32)
    z0, y0, x0 = (int(v) for v in lo)
    z1, y1, x1 = (int(v) for v in hi)
    m[z0:z1, y0:y1, x0:x1] = 0.0
    return torch.as_tensor(m, device=device)


def sphere_mask(g: GridSpec, center, radius: float, device="cuda") -> torch.Tensor:
    """Fluid mask with a solid sphere: center (cz, cy, cx) in cell indices,
    radius in physical units (the grid may be anisotropic)."""
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    cz, cy, cx = center
    r2 = ((z - cz) * g.hz) ** 2 + ((y - cy) * g.hy) ** 2 + ((x - cx) * g.hx) ** 2
    return torch.as_tensor((r2 > radius * radius).astype(np.float32), device=device)


def union(*masks: torch.Tensor) -> torch.Tensor:
    """Fluid mask of the union of the SOLIDS (intersection of fluids)."""
    out = masks[0]
    for m in masks[1:]:
        out = out * m
    return out


def complement(mask: torch.Tensor) -> torch.Tensor:
    """Swap fluid and solid."""
    return 1.0 - mask


def validate_mask(g: GridSpec, mask: torch.Tensor) -> torch.Tensor:
    """Shape and value checks (0/1 only: a 0.5 would attenuate velocity and
    density instead of modelling a solid, since no-slip is a multiply);
    raises ValueError. Returns the mask as float32."""
    if tuple(mask.shape) != g.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != grid shape {g.shape}")
    m = torch.as_tensor(mask).to(torch.float32)
    vals = np.unique(m.cpu().numpy())
    if not np.all((vals == 0.0) | (vals == 1.0)):
        raise ValueError(f"mask must be 0/1, got values {vals[:8]}")
    return m


# -------------------------------------------------------------- no-slip


def apply_no_slip(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the velocity inside solid cells: u * mask over the channel axis.
    u: [3, nz, ny, nx] (or [nz, ny, nx] for a scalar field)."""
    if u.ndim == mask.ndim + 1:
        return u * mask[None]
    return u * mask


# ---------------------------------------------------- masked projection


def project_masked(
    g: GridSpec, u: torch.Tensor, mask: torch.Tensor, *, maxiter: int = 200, tol: float = 1e-6
) -> torch.Tensor:
    """Masked Helmholtz projection: u_s - M_v G p with p the CGNR
    least-squares minimizer of the fluid-cell divergence; zero in solids."""
    assert tuple(u.shape) == (3,) + g.shape, (u.shape, g.shape)
    assert tuple(mask.shape) == g.shape, (mask.shape, g.shape)
    u_s = apply_no_slip(u, mask)
    d = mask * divergence(g, u_s)
    # fluid-mean removal: the constant-in-fluid mode is (near-)invisible to
    # the masked operator; removing it keeps CGNR off the incompatible part
    n_fluid = torch.clamp_min(torch.sum(mask), 1.0)
    d = mask * (d - torch.sum(d) / n_fluid)

    def fwd(p):
        return mask * divergence(g, apply_no_slip(grad(g, p), mask))

    p = normal_solve(fwd, d, maxiter=maxiter, tol=tol)
    return u_s - apply_no_slip(grad(g, p), mask)


def fluid_divergence(g: GridSpec, u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """max |div u| over INTERIOR fluid cells: fluid cells whose +-1 stencil
    ring is fluid too (the mask eroded by one cell in the six stencil
    directions, with the grid's own boundary topology)."""
    interior = mask
    for axis in (0, 1, 2):
        if g.periodic:
            interior = interior * torch.roll(mask, 1, axis) * torch.roll(mask, -1, axis)
        else:
            interior = interior * _shift_clamp(mask, 1, axis) * _shift_clamp(mask, -1, axis)
    return torch.max(torch.abs(interior * divergence(g, u)))


def _shift_clamp(f: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Shift with edge replication (the clamp boundary's neighbour rule)."""
    n = f.shape[axis]
    idx = torch.clamp(torch.arange(n, device=f.device) + off, 0, n - 1)
    return torch.index_select(f, axis, idx)
