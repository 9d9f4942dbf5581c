"""Staged transport residuals in plain PyTorch
(port of phys_autodiff_tpu/ops/stencil.py).

The referee of every kernel in the port: float32 elementwise ops in the
same order as the JAX staged arm, differentiable by autograd.

Layout: scalar fields [nz, ny, nx]; vector fields [3, nz, ny, nx].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec


class FieldSnapshots(NamedTuple):
    """The six physics input fields at t-dt, t, t+dt."""

    sigma_tm1: torch.Tensor  # [nz, ny, nx]
    sigma_t: torch.Tensor  # [nz, ny, nx]
    sigma_tp1: torch.Tensor  # [nz, ny, nx]
    u_tm1: torch.Tensor  # [3, nz, ny, nx]
    u_t: torch.Tensor  # [3, nz, ny, nx]
    u_tp1: torch.Tensor  # [3, nz, ny, nx]


def shift(f: torch.Tensor, delta: int, axis: int, periodic: bool) -> torch.Tensor:
    """f at index i+delta along `axis`: periodic wrap (torch.roll) or edge
    clamp (out-of-range neighbours read the edge plane)."""
    if delta == 0:
        return f
    if periodic:
        return torch.roll(f, -delta, dims=axis)
    n = f.shape[axis]
    idx = torch.clamp(torch.arange(n, device=f.device) + delta, 0, n - 1)
    return torch.index_select(f, axis, idx)


def inv2h_f32(h: float) -> np.float32:
    """The central-difference scale constant 1/(2h) with the exact f32
    rounding of the JAX operator: np.float32(1.0/(2.0*f32(h)))."""
    return np.float32(1.0 / (2.0 * float(np.float32(h))))


def invh_f32(h: float) -> np.float32:
    """The upwind scale constant 1/h, rounded like the JAX operator."""
    return np.float32(1.0 / float(np.float32(h)))


def central_diff(f: torch.Tensor, axis: int, inv2h: float, periodic: bool) -> torch.Tensor:
    """(f[i+1] - f[i-1]) * inv2h along `axis`."""
    return (shift(f, +1, axis, periodic) - shift(f, -1, axis, periodic)) * float(inv2h)


def upwind_diff(
    f: torch.Tensor, a: torch.Tensor, axis: int, invh: float, periodic: bool
) -> torch.Tensor:
    """First-order upwind derivative of f along `axis` advected by a:
    backward difference where a > 0, forward otherwise (strict)."""
    bwd = (f - shift(f, -1, axis, periodic)) * float(invh)
    fwd = (shift(f, +1, axis, periodic) - f) * float(invh)
    return torch.where(a > 0.0, bwd, fwd)


def _advection(g: GridSpec, s_t, u_t, grads_central):
    """Advection terms (adv_sigma, adv_u) under g.scheme."""
    ux, uy, uz = u_t[0], u_t[1], u_t[2]
    if g.scheme != "upwind":
        ds_dx, ds_dy, ds_dz, du_dx, du_dy, du_dz = grads_central
        adv_sigma = ux * ds_dx + uy * ds_dy + uz * ds_dz
        adv_u = ux[None] * du_dx + uy[None] * du_dy + uz[None] * du_dz
        return adv_sigma, adv_u
    ndim = s_t.ndim
    ax_z, ax_y, ax_x = ndim - 3, ndim - 2, ndim - 1
    invhx, invhy, invhz = invh_f32(g.hx), invh_f32(g.hy), invh_f32(g.hz)
    per = g.periodic

    def adv(f):
        return (
            ux * upwind_diff(f, ux, ax_x, invhx, per)
            + uy * upwind_diff(f, uy, ax_y, invhy, per)
            + uz * upwind_diff(f, uz, ax_z, invhz, per)
        )

    return adv(s_t), torch.stack([adv(ux), adv(uy), adv(uz)])


def residuals(g: GridSpec, fields: FieldSnapshots):
    """Transport residuals

        R_sigma = d sigma/dt + u . grad(sigma) + sigma * div(u)
        R_u     = d u/dt + (u . grad) u

    Returns (R_sigma [nz,ny,nx], R_u [3,nz,ny,nx]) in float32.
    """
    s_t = fields.sigma_t
    u_t = fields.u_t
    ndim = s_t.ndim
    ax_z, ax_y, ax_x = ndim - 3, ndim - 2, ndim - 1

    inv2dt = inv2h_f32(g.dt)
    inv2hx = inv2h_f32(g.hx)
    inv2hy = inv2h_f32(g.hy)
    inv2hz = inv2h_f32(g.hz)
    per = g.periodic

    dt_sigma = (fields.sigma_tp1 - fields.sigma_tm1) * float(inv2dt)
    du_dt = (fields.u_tp1 - fields.u_tm1) * float(inv2dt)

    ds_dx = central_diff(s_t, ax_x, inv2hx, per)
    ds_dy = central_diff(s_t, ax_y, inv2hy, per)
    ds_dz = central_diff(s_t, ax_z, inv2hz, per)

    # du[c, a] = d u_c / d a, batched over the channel axis
    du_dx = central_diff(u_t, ax_x + 1, inv2hx, per)
    du_dy = central_diff(u_t, ax_y + 1, inv2hy, per)
    du_dz = central_diff(u_t, ax_z + 1, inv2hz, per)

    div_u = du_dx[0] + du_dy[1] + du_dz[2]  # central in both schemes
    adv_sigma, adv_u = _advection(g, s_t, u_t, (ds_dx, ds_dy, ds_dz, du_dx, du_dy, du_dz))

    r_sigma = dt_sigma + adv_sigma + s_t * div_u
    r_u = du_dt + adv_u
    return r_sigma, r_u
