"""Weighted MSE physics loss (port of phys_autodiff_tpu/ops/loss.py).

    L_sigma = w_sigma * sum(R_sigma^2) / N
    L_u     = w_u * sum(R_ux^2 + R_uy^2 + R_uz^2) / N     (mean over N, not 3N)
    backward (w.r.t. residuals): g = (2 w / N) * R

Reductions:
  * `loss_forward` — float32 on the device, differentiable.
  * `loss_forward_f64` — residuals on the device, float64 reduction.
  * `plane_partials` + `sum_partials` — per-z-plane partials [2, nz]
    combined in a fixed sequential order (the contract the fused kernels'
    partials epilogue follows).
  * `loss_backward` — the reference-shaped residual-space VJP.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, PhysWeights
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots, residuals


def inv_n_f32(g: GridSpec) -> np.float32:
    """1/N rounded to float32, as every reduction in the package uses it."""
    return np.float32(1.0 / g.num_cells)


def loss_scales_f32(g: GridSpec, w: PhysWeights) -> tuple[np.float32, np.float32]:
    """(2 w_sigma / N, 2 w_u / N) computed in float32 like the reference."""
    n = np.float32(g.num_cells)
    return (
        np.float32(2.0) * np.float32(w.w_sigma) / n,
        np.float32(2.0) * np.float32(w.w_u) / n,
    )


def loss_terms(g: GridSpec, w: PhysWeights, r_sigma, r_u):
    """(L_sigma, L_u) from residuals, float32 reduction on the device."""
    inv_n = float(inv_n_f32(g))
    l_sigma = float(np.float32(w.w_sigma)) * torch.sum(r_sigma * r_sigma) * inv_n
    l_u = float(np.float32(w.w_u)) * torch.sum(r_u * r_u) * inv_n
    return l_sigma, l_u


def loss_forward(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """(L_sigma, L_u) — differentiable end to end."""
    r_sigma, r_u = residuals(g, fields)
    return loss_terms(g, w, r_sigma, r_u)


def total_loss(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """Scalar L = L_sigma + L_u, the training objective."""
    l_sigma, l_u = loss_forward(g, w, fields)
    return l_sigma + l_u


def loss_forward_f64(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """Device residuals + float64 reduction; returns numpy float32 scalars."""
    r_sigma, r_u = residuals(g, fields)
    n = float(g.num_cells)
    acc_sigma = torch.sum(r_sigma.detach().double() ** 2).item()
    acc_u = torch.sum(r_u.detach().double() ** 2).item()
    return np.float32(w.w_sigma * acc_sigma / n), np.float32(w.w_u * acc_u / n)


def plane_partials(r_sigma, r_u):
    """Per-z-plane raw partial sums [2, nz] of the residual squares: the
    squares summed in float64 and rounded once, so a plane's value does not
    depend on how many planes the tensor holds or on its layout (a shard's
    or a slab's rows against the whole grid's) or on the order a machine's
    reduction takes."""
    ps = torch.sum((r_sigma * r_sigma).double(), dim=(-2, -1))
    pu = torch.sum((r_u * r_u).double(), dim=(0, -2, -1))
    return torch.stack([ps, pu]).to(r_sigma.dtype)


def sum_partials(g: GridSpec, w: PhysWeights, parts):
    """Fixed-order sequential combination of [2, nz] per-plane partials into
    (L_sigma, L_u): ((0 + p[0]) + p[1]) + ... in float32."""
    s = parts.new_zeros(())
    u = parts.new_zeros(())
    for i in range(parts.shape[1]):
        s = s + parts[0, i]
        u = u + parts[1, i]
    inv_n = float(inv_n_f32(g))
    return float(np.float32(w.w_sigma)) * s * inv_n, float(np.float32(w.w_u)) * u * inv_n


def loss_forward_planewise(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """(L_sigma, L_u) with the deterministic plane-partial reduction."""
    r_sigma, r_u = residuals(g, fields)
    return sum_partials(g, w, plane_partials(r_sigma, r_u))


def loss_backward(g: GridSpec, w: PhysWeights, r_sigma, r_u):
    """Residual-space VJP g = (2 w / N) * R, scales in float32."""
    ss, su = loss_scales_f32(g, w)
    return float(ss) * r_sigma, float(su) * r_u
