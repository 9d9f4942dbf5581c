"""The coordinate MLP, 4 -> H -> 4 with ReLU, written out:

    [sigma, ux, uy, uz] = relu([x, y, z, t] W1 + b1) W2 + b2

W1 [4, H], b1 [H], W2 [H, 4], b2 [4]. The coordinates are 2 i / (n - 1) - 1
("minus_one_to_one", the time channel the raw t) or i / (n - 1) (the time
channel t + 0.5), as the configuration's `norm` says.
"""

from __future__ import annotations

import torch

from portbench.reference.grid import Grid, axis_coord, f32
from portbench.reference.precision import Precision, matmul


def _coords(cfg: dict, g: Grid, rows: torch.Tensor, t: float, prec: Precision) -> torch.Tensor:
    """[R, ny, nx, 4] inputs of the given z planes at time t."""
    m11 = cfg["norm"] == "minus_one_to_one"
    dev = rows.device
    cx, cy = axis_coord(g.nx, m11, dev), axis_coord(g.ny, m11, dev)
    cz = axis_coord(g.nz, m11, dev)[rows]
    tt = torch.tensor(t if m11 else f32(f32(t) + 0.5), dtype=torch.float32, device=dev)
    shape = (rows.numel(), g.ny, g.nx)
    xyzt = torch.stack(
        [cx[None, None, :].expand(shape), cy[None, :, None].expand(shape), cz[:, None, None].expand(shape),
         tt.expand(shape)], dim=-1)
    return xyzt.to(prec.dtype)


def _forward(params: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    a1 = torch.clamp_min(matmul(x, params["W1"], prec) + params["b1"], 0.0)
    return matmul(a1, params["W2"], prec) + params["b2"]


def field(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, t: float, prec: Precision) -> torch.Tensor:
    """[R, ny, nx, 4] of the given planes at time t."""
    return _forward(params, _coords(cfg, g, rows, t, prec), prec)


def fields(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, ts, prec: Precision):
    """(sigma [S, R, ny, nx], u [S, 3, R, ny, nx]) at the times ts."""
    ys = torch.stack([field(cfg, params, g, rows, t, prec) for t in ts])
    return ys[..., 0], torch.movedim(ys[..., 1:4], -1, 1)


def rows_per_block(cfg: dict, g: Grid, budget_bytes: float) -> int:
    """Planes a block may hold: three slices' hidden activations, kept for
    the backward, within the budget (float64)."""
    per_plane = 3 * g.ny * g.nx * cfg["dims"]["H"] * 8 * 3
    return max(1, int(budget_bytes // per_plane) - 2)
