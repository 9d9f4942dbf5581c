"""The grid, the times and the residual stencil of the physics loss.

    R_sigma = d sigma/dt + u . grad(sigma) + sigma div(u)
    R_u     = d u/dt + (u . grad) u
    L       = w_sigma sum(R_sigma^2) / N + w_u sum(|R_u|^2) / N

central differences, periodic in x, y and z. The inputs of the model are
float32 values, as the configurations state them: the grid coordinates
(i / (n - 1), or 2 i / (n - 1) - 1), the slice times f32(t) -+ f32(dt) and
the cell sizes; the reference computes with them in its own precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Grid:
    nx: int
    ny: int
    nz: int
    hx: float
    hy: float
    hz: float
    dt: float
    periodic: bool = True
    scheme: str = "central"

    def __post_init__(self):
        if not self.periodic or self.scheme != "central":
            raise ValueError("the reference stencil is central and periodic")

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz


def slice_times(t, dt) -> list[float]:
    """[t - dt, t, t + dt] in float32 arithmetic."""
    t32, dt32 = np.float32(t), np.float32(dt)
    return [float(np.float32(t32 - dt32)), float(t32), float(np.float32(t32 + dt32))]


def axis_coord(n: int, minus_one_to_one: bool, device) -> torch.Tensor:
    """The float32 coordinates of n nodes: i / (n - 1), or 2 i / (n - 1) - 1."""
    if n <= 1:
        return torch.zeros((max(n, 1),), dtype=torch.float32, device=device)
    u = torch.arange(n, dtype=torch.float32, device=device) / f32(n - 1)
    return 2.0 * u - 1.0 if minus_one_to_one else u


def row_blocks(nz: int, rows: int):
    """[z0, z1) blocks of at most `rows` planes covering [0, nz)."""
    return [(z0, min(z0 + rows, nz)) for z0 in range(0, nz, rows)]


def rows_with_halo(nz: int, z0: int, z1: int, device) -> torch.Tensor:
    """The planes z0 - 1 .. z1, wrapped: a block and one plane a side."""
    return torch.remainder(torch.arange(z0 - 1, z1 + 1, device=device), nz)


def residuals_ext(g: Grid, sigma: torch.Tensor, u: torch.Tensor):
    """Residuals of the interior planes of an extended block.

    sigma [3, R, ny, nx] and u [3, 3, R, ny, nx] hold the slices t - dt, t,
    t + dt of R = planes + 2 consecutive planes (one a side); returns
    R_sigma [R - 2, ny, nx] and R_u [3, R - 2, ny, nx]."""
    inv2dt, inv2hx, inv2hy, inv2hz = (1.0 / (2.0 * f32(v)) for v in (g.dt, g.hx, g.hy, g.hz))

    def ddx(f):  # f [..., ny, nx]
        return (torch.roll(f, -1, -1) - torch.roll(f, 1, -1)) * inv2hx

    def ddy(f):
        return (torch.roll(f, -1, -2) - torch.roll(f, 1, -2)) * inv2hy

    def ddz(ext):  # ext [..., R, ny, nx] -> interior planes
        return (ext[..., 2:, :, :] - ext[..., :-2, :, :]) * inv2hz

    s, uu = sigma[1, 1:-1], u[1][:, 1:-1]
    dsdt = (sigma[2, 1:-1] - sigma[0, 1:-1]) * inv2dt
    dudt = (u[2][:, 1:-1] - u[0][:, 1:-1]) * inv2dt
    ux, uy, uz = uu[0], uu[1], uu[2]
    grad_s = (ddx(s), ddy(s), ddz(sigma[1]))
    du = (ddx(uu), ddy(uu), ddz(u[1]))  # du[a][c] = d u_c / d a
    div = du[0][0] + du[1][1] + du[2][2]
    r_sigma = dsdt + ux * grad_s[0] + uy * grad_s[1] + uz * grad_s[2] + s * div
    r_u = dudt + ux[None] * du[0] + uy[None] * du[1] + uz[None] * du[2]
    return r_sigma, r_u
