"""Field diagnostics: divergence, curl (vorticity) and kinetic energy (port of
phys_autodiff_tpu/ops/diagnostics.py).

Built from the residual stencil's central_diff, so the boundary semantics
(periodic wrap / clamp) are those of the residual operator. Plain PyTorch,
differentiable by autograd; u is channel-major [3, nz, ny, nx].
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.ops.stencil import central_diff, inv2h_f32
from phys_autodiff_tpu_torch.utils.config import GridSpec

# component axes within one [nz, ny, nx] field
_AX_Z, _AX_Y, _AX_X = 0, 1, 2


def divergence(g: GridSpec, u: torch.Tensor) -> torch.Tensor:
    """div u = dux/dx + duy/dy + duz/dz, central differences: [nz, ny, nx]."""
    assert u.shape[0] == 3, u.shape
    per = g.periodic
    return (
        central_diff(u[0], _AX_X, inv2h_f32(g.hx), per)
        + central_diff(u[1], _AX_Y, inv2h_f32(g.hy), per)
        + central_diff(u[2], _AX_Z, inv2h_f32(g.hz), per)
    )


def curl(g: GridSpec, u: torch.Tensor) -> torch.Tensor:
    """Vorticity w = curl u, channel-major [3, nz, ny, nx]:
    w_x = duz/dy - duy/dz, w_y = dux/dz - duz/dx, w_z = duy/dx - dux/dy."""
    assert u.shape[0] == 3, u.shape
    per = g.periodic
    ix, iy, iz = inv2h_f32(g.hx), inv2h_f32(g.hy), inv2h_f32(g.hz)
    wx = central_diff(u[2], _AX_Y, iy, per) - central_diff(u[1], _AX_Z, iz, per)
    wy = central_diff(u[0], _AX_Z, iz, per) - central_diff(u[2], _AX_X, ix, per)
    wz = central_diff(u[1], _AX_X, ix, per) - central_diff(u[0], _AX_Y, iy, per)
    return torch.stack([wx, wy, wz])


def kinetic_energy(u: torch.Tensor) -> torch.Tensor:
    """Mean kinetic energy density 0.5 * mean(|u|^2) (unit density)."""
    assert u.shape[0] == 3, u.shape
    return 0.5 * torch.mean(torch.sum(u * u, dim=0))


def field_stats(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor) -> dict:
    """Health summary of a field snapshot, as 0-dim tensors: sigma/u
    extrema, mean kinetic energy, max |div u|, max |curl u|."""
    return {
        "sigma_min": torch.min(sigma),
        "sigma_max": torch.max(sigma),
        "u_max_abs": torch.max(torch.abs(u)),
        "kinetic_energy": kinetic_energy(u),
        "div_max_abs": torch.max(torch.abs(divergence(g, u))),
        "curl_max_abs": torch.max(torch.abs(curl(g, u))),
    }
