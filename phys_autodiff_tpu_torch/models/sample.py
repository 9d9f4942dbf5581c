"""Arbitrary-point field evaluation, the serving surface (port of
phys_autodiff_tpu/models/sample.py).

Every model family serves here: the coordinate MLP, the encoded fields (hash,
Fourier, any registered encoder family), and a trilinear grid sampler for
consumers that want many cheap queries against a frozen field snapshot.

Coordinate conventions:

  * UNIT coords: u in [0, 1]^3, channel order (x, y, z): the encoder
    convention and the MLP's ZeroToOne axis coordinate u = i / (n - 1)
    (models/coords._axis_coord). Grid node (ix, iy, iz) sits at
    u = (ix / (nx-1), iy / (ny-1), iz / (nz-1)).
  * INDEX coords: f = u * (n - 1) per axis, continuous grid indices, the
    space of interpolation (the periodic topology has period n there).

Plain PyTorch, differentiable by autograd in the model parameters and the
query points; the device follows the params and the points.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.models import fields as fields_mod
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.utils.config import CoordNorm, GridSpec, MLPGridConfig


def _index_scale(g: GridSpec, device) -> torch.Tensor:
    return torch.tensor([max(g.nx - 1, 1), max(g.ny - 1, 1), max(g.nz - 1, 1)], dtype=torch.float32, device=device)


def unit_to_index(g: GridSpec, pts_unit: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit-cube coords -> continuous grid-index coords (x, y, z)."""
    return pts_unit.to(torch.float32) * _index_scale(g, pts_unit.device)


def index_to_unit(g: GridSpec, pts_idx: torch.Tensor) -> torch.Tensor:
    """Inverse of unit_to_index (degenerate axes map index 0 -> unit 0)."""
    return pts_idx.to(torch.float32) / _index_scale(g, pts_idx.device)


def point_coords(pts_unit: torch.Tensor, t, norm: CoordNorm = CoordNorm.MinusOneToOne) -> torch.Tensor:
    """MLP input coords [..., 4] for unit-cube points at time t.

    The grid path's normalization (models/coords.py), the reference's time
    quirk included (raw t for MinusOneToOne, t + 0.5 for ZeroToOne), so a
    point placed exactly on a grid node reproduces that node's grid_coords
    row bit for bit. A tensor t stays a tensor (autograd reaches it)."""
    pts_unit = pts_unit.to(torch.float32)
    t_val = torch.as_tensor(t, dtype=torch.float32, device=pts_unit.device)
    if norm == CoordNorm.MinusOneToOne:
        spatial = 2.0 * pts_unit - 1.0
    else:
        spatial = pts_unit
        t_val = t_val + 0.5
    t_chan = t_val.expand(pts_unit.shape[:-1] + (1,))
    return torch.cat([spatial, t_chan], dim=-1)


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, held in float32: a product of two such values
    is exact in float32, so float32 matmuls of them multiply bf16 operands
    and accumulate in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mlp_eval_points(cfg: MLPGridConfig, params: mlp.Params, pts_unit: torch.Tensor, t,
                    precision: str = "f32") -> torch.Tensor:
    """Coordinate-MLP field at arbitrary unit-cube points: [..., Out].

    precision="f32": at grid nodes this is models.fields.grid_infer (same
    coordinate rows, same float32 matmuls). precision="bf16": the operands
    of both matmuls rounded to bfloat16 and the products accumulated in
    float32 (the JAX package's preferred_element_type=f32 tier, 1e-3-class
    error)."""
    x = point_coords(pts_unit, t, cfg.norm)
    if precision == "f32":
        return mlp.forward(params, x)
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    z1 = torch.matmul(_bf16_operand(x), _bf16_operand(params["W1"])) + params["b1"]
    a1 = torch.clamp_min(z1, 0.0)
    return torch.matmul(_bf16_operand(a1), _bf16_operand(params["W2"])) + params["b2"]


def ngp_eval_points(ncfg, params: dict, pts_unit: torch.Tensor, t, *, allow_large: bool = False) -> torch.Tensor:
    """Encoded-field evaluation at arbitrary unit-cube points: [..., out]
    (models.ngp.forward). The hash family's pointwise encoder keeps its
    guard (hash_encoder.MAX_POINTWISE_POINTS): batch the queries
    (evaluate_points_batched) or pass allow_large=True."""
    return ngp_mod.forward(ncfg, params, pts_unit, t, allow_large=allow_large)


def evaluate_points(model_cfg, params, pts_unit, t, precision: str = "f32", **kw) -> torch.Tensor:
    """[..., 4] physics channels [sigma, ux, uy, uz] at unit-cube points and
    time t, for an MLPGridConfig or an NGPFieldConfig (any encoder family).
    pts_unit must lie in [0, 1]^3, the models' domain. precision="bf16" is
    served for the MLP family only."""
    if isinstance(model_cfg, MLPGridConfig):
        return mlp_eval_points(model_cfg, params, pts_unit, t, precision)
    if precision != "f32":
        raise ValueError(
            "bf16 point serving is implemented for the coordinate MLP family only (encoded "
            "families keep their exact-f32 pointwise encoders)"
        )
    return ngp_eval_points(model_cfg, params, pts_unit, t, **kw)


def grid_infer_any(g: GridSpec, model_cfg, params, t) -> torch.Tensor:
    """[nz, ny, nx, 4] model output on the full grid for either family."""
    if isinstance(model_cfg, MLPGridConfig):
        return fields_mod.grid_infer(g, model_cfg, params, t)
    return ngp_mod.grid_infer(g, model_cfg, params, t)


def evaluate_points_batched(model_cfg, params, pts_unit: torch.Tensor, t, batch_size: int = 1 << 16,
                            **kw) -> torch.Tensor:
    """evaluate_points over any number of points [P, 3] -> [P, 4], in chunks
    of `batch_size` evaluated one after another (bounded memory; each chunk
    stays under the hash family's pointwise guard when batch_size does)."""
    p = pts_unit.shape[0]
    if p <= batch_size:
        return evaluate_points(model_cfg, params, pts_unit, t, **kw)
    return torch.cat(
        [evaluate_points(model_cfg, params, pts_unit[i : i + batch_size], t, **kw) for i in range(0, p, batch_size)]
    )


def _axis_corners(f: torch.Tensor, n: int, periodic: bool):
    """Continuous index coordinate f -> (i0, i1, w1) on an n-node axis.

    periodic: f wraps with period n (node n is node 0, the stencil's wrap
    topology). clamp: f clips to [0, n-1] and the upper corner saturates, so
    queries outside the box return the boundary value."""
    if n <= 1:
        z = torch.zeros_like(f, dtype=torch.int64)
        return z, z, torch.zeros_like(f)
    if periodic:
        f = torch.remainder(f, float(np.float32(n)))
        i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 1)  # guard f == n after the mod
        i1 = torch.remainder(i0 + 1, n)
    else:
        f = torch.clamp(f, 0.0, float(n - 1))
        i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 1)
        i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, f - i0.to(torch.float32)


def trilinear_sample(values: torch.Tensor, pts_idx: torch.Tensor, g: GridSpec) -> torch.Tensor:
    """Trilinear interpolation of grid values at continuous index coords.

    values: [..., nz, ny, nx] (any leading channel axes); pts_idx: [P, 3]
    (x, y, z) grid-index coordinates; returns [P, ...channels]. Boundary
    behaviour follows g.periodic (wrap with period n, or clamp)."""
    ch_shape = values.shape[:-3]
    nz, ny, nx = values.shape[-3:]
    if (nz, ny, nx) != g.shape:
        raise ValueError(f"values of shape {tuple(values.shape)} do not lie on the grid {g.shape}")
    flat = values.reshape(ch_shape + (nz * ny * nx,))
    ix0, ix1, wx = _axis_corners(pts_idx[..., 0], nx, g.periodic)
    iy0, iy1, wy = _axis_corners(pts_idx[..., 1], ny, g.periodic)
    iz0, iz1, wz = _axis_corners(pts_idx[..., 2], nz, g.periodic)

    def corner(iz, iy, ix):
        return flat[..., (iz * ny + iy) * nx + ix]  # [...ch, P]

    c00 = corner(iz0, iy0, ix0) + (corner(iz0, iy0, ix1) - corner(iz0, iy0, ix0)) * wx
    c01 = corner(iz0, iy1, ix0) + (corner(iz0, iy1, ix1) - corner(iz0, iy1, ix0)) * wx
    c10 = corner(iz1, iy0, ix0) + (corner(iz1, iy0, ix1) - corner(iz1, iy0, ix0)) * wx
    c11 = corner(iz1, iy1, ix0) + (corner(iz1, iy1, ix1) - corner(iz1, iy1, ix0)) * wx
    c0 = c00 + (c01 - c00) * wy
    c1 = c10 + (c11 - c10) * wy
    out = c0 + (c1 - c0) * wz  # [...ch, P]
    return torch.movedim(out, -1, 0) if ch_shape else out
