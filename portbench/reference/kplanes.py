"""The K-Planes field (Fridovich-Keil et al., CVPR 2023, arXiv:2301.10241),
written out.

Six planes (a, b) of the axes x, y, z, t (itertools.combinations order: xy,
xz, xt, yz, yt, zt), each [F, R_b, R_a] (the published grid [1, F, R_b,
R_a] without its batch axis), at each scale l: spatial resolution
base x multipliers[l] a side, time resolution T. A point's feature of scale
l is the product of the six planes' samples, grid_sample(align_corners=
True, padding_mode="border") at the pair of its coordinates in [-1, 1]
(x, y, z: 2u - 1 of the float32 grid coordinates u; t: 2t - 1); the
scales concatenate into LF = scales x F features. The head:
[sigma, ux, uy, uz] = relu(enc W1 + b1) W2 + b2, W1 [LF, H], with no time
input.

A plane's sample depends on two coordinates alone, so on a grid each plane
is sampled once at its axes' nodes, by grid_sample itself, and a cell's
feature is the product of its six node samples: (XY XT YT) (XZ ZT) YZ, in
the precision's arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.grid import Grid, axis_coord
from portbench.reference.precision import Precision, matmul

PLANES = ("xy", "xz", "xt", "yz", "yt", "zt")


def plane_shape(enc: dict, scale: int, plane: str) -> tuple[int, int, int]:
    """[F, R_b, R_a] of `plane` at `scale` of the configuration's encoding."""
    r = enc["base_resolution"] * enc["multipliers"][scale]
    a, b = plane
    return (enc["features"], enc["time_resolution"] if b == "t" else r, enc["time_resolution"] if a == "t" else r)


def _sample(plane: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """plane [F, R_b, R_a] at every pair (ca [Na], cb [Nb]) -> [Nb, Na, F]."""
    grid = torch.stack([ca[None, :].expand(cb.numel(), -1), cb[:, None].expand(-1, ca.numel())], dim=-1)
    v = F.grid_sample(plane[None], grid[None].to(plane.dtype), mode="bilinear", padding_mode="border",
                      align_corners=True)  # [1, F, Nb, Na]
    return v[0].permute(1, 2, 0)


def encode(enc: dict, tables: dict, g: Grid, rows: torch.Tensor, t: float, dtype) -> torch.Tensor:
    """[R, ny, nx, LF] encoding of the given z planes at time t."""
    dev = rows.device
    c = {"x": axis_coord(g.nx, True, dev), "y": axis_coord(g.ny, True, dev),
         "z": axis_coord(g.nz, True, dev)[rows],
         "t": 2.0 * torch.tensor([t], dtype=torch.float32, device=dev) - 1.0}
    outs = []
    for l in range(len(enc["multipliers"])):
        s = {p: _sample(tables[f"s{l}"][p].to(dtype), c[p[0]], c[p[1]]) for p in PLANES}
        # s["xy"] [ny, nx, F], s["xz"] [R, nx, F], s["yz"] [R, ny, F], s["xt"] [1, nx, F], s["yt"] [1, ny, F],
        # s["zt"] [1, R, F]
        a = s["xy"] * s["xt"] * s["yt"][0][:, None, :]  # [ny, nx, F]
        b = s["xz"] * s["zt"][0][:, None, :]  # [R, nx, F]
        outs.append((a[None] * b[:, None]) * s["yz"][:, :, None, :])  # [R, ny, nx, F]
    return torch.cat(outs, dim=-1)


def _head(params: dict, e: torch.Tensor, prec: Precision) -> torch.Tensor:
    a1 = torch.clamp_min(matmul(e, params["W1"], prec) + params["b1"], 0.0)
    return matmul(a1, params["W2"], prec) + params["b2"]


def field(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, t: float, prec: Precision) -> torch.Tensor:
    """[R, ny, nx, 4] of the given planes at time t."""
    return _head(params, encode(cfg["encoding"], params["tables"], g, rows, t, prec.dtype), prec)


def fields(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, ts, prec: Precision):
    """(sigma [S, R, ny, nx], u [S, 3, R, ny, nx]) at the times ts, an
    encoding a time."""
    ys = torch.stack([field(cfg, params, g, rows, t, prec) for t in ts])
    return ys[..., 0], torch.movedim(ys[..., 1:4], -1, 1)


def rows_per_block(cfg: dict, g: Grid, budget_bytes: float) -> int:
    """Planes a block may hold: for each of three slices, the encoding's
    products and the head's activations kept for the backward (float64)."""
    lf = len(cfg["encoding"]["multipliers"]) * cfg["encoding"]["features"]
    per_plane = g.ny * g.nx * 8 * 3 * (3 * lf + 4 * cfg["hidden"])
    return max(1, int(budget_bytes // per_plane) - 2)

