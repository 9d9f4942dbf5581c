"""The plain reference of the K-Planes field (Fridovich-Keil et al., CVPR
2023, arXiv:2301.10241), written as the published code samples its planes:
torch.nn.functional.grid_sample on the 4-D coordinates (x, y, z, t) in
[-1, 1], align_corners=True, padding_mode="border", the six planes of a
scale (itertools.combinations of the four axes) multiplied in that order,
the scales concatenated; the head relu(enc W1 + b1) W2 + b2 with no time
column. It imports no kernel or model of the port, and runs its matmuls
with TF32 off.

Parameters, as the port stores them: {"tables": {"s<l>": {"xy": [F, Ry,
Rx], "xz", "xt", "yz", "yt", "zt"}}, "W1": [LF, H], "b1", "W2": [H, 4],
"b2"}: plane (a, b) is the published grid [1, F, R_b, R_a] without its
batch axis. The inputs are float32 values: the grid coordinates i / (n - 1)
in float32, mapped to 2u - 1, and the slice times; the reference computes
with them in the dtype it is given.
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
import torch.nn.functional as F

_AXES = "xyzt"


@contextlib.contextmanager
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def interpolate_features(tables: dict, pts: torch.Tensor) -> torch.Tensor:
    """pts [N, 4] in [-1, 1] (x, y, z, t) -> [N, LF], as the published
    interpolate_ms_features (concat_features_across_scales=True)."""
    outs = []
    for l in range(len(tables)):
        scale = tables[f"s{l}"]
        feat = 1.0
        for i, j in itertools.combinations(range(4), 2):
            grid = scale[_AXES[i] + _AXES[j]][None]  # [1, F, R_j, R_i]
            coords = pts[:, [i, j]].reshape(1, 1, -1, 2)
            v = F.grid_sample(grid, coords.to(grid.dtype), mode="bilinear", padding_mode="border",
                              align_corners=True)  # [1, F, 1, N]
            feat = feat * v[0, :, 0, :].T
        outs.append(feat)
    return torch.cat(outs, dim=-1)


def grid_points(g, t, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[nz ny nx, 4] coordinates of the grid's nodes (z-major, x fastest)
    at time t: 2u - 1 of the float32 u = i / (n - 1), 2t - 1 of the float32
    t."""

    def axis(n):
        if n <= 1:
            return np.full((max(n, 1),), -1.0, dtype=np.float32)
        return np.float32(2.0) * (np.arange(n, dtype=np.float32) / np.float32(n - 1)) - np.float32(1.0)

    cz, cy, cx = (torch.tensor(axis(n), dtype=dtype, device=device) for n in (g.nz, g.ny, g.nx))
    zz, yy, xx = torch.meshgrid(cz, cy, cx, indexing="ij")
    tc = (2.0 * torch.as_tensor(t, dtype=torch.float32) - 1.0).to(dtype=dtype, device=device)
    return torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1), tc.expand(xx.numel())], dim=-1)


def field(params: dict, g, t) -> torch.Tensor:
    """[nz, ny, nx, 4] at time t (a float32 value or tensor), in the params'
    dtype."""
    w1 = params["W1"]
    with _no_tf32():
        enc = interpolate_features(params["tables"], grid_points(g, t, w1.dtype, w1.device))
        a1 = torch.clamp_min(enc @ w1 + params["b1"], 0.0)
        y = a1 @ params["W2"] + params["b2"]
    return y.reshape(g.nz, g.ny, g.nx, -1)


def slice_fields(params: dict, g, t, dt):
    """The three slices t - dt, t, t + dt (float32 times, as the port forms
    them): (sigma [3, nz, ny, nx], u [3, 3, nz, ny, nx])."""
    t32, dt32 = np.float32(t), np.float32(dt)
    ts = [np.float32(t32 - dt32), t32, np.float32(t32 + dt32)]
    ys = [field(params, g, float(tt)) for tt in ts]
    sigma = torch.stack([y[..., 0] for y in ys])
    u = torch.stack([torch.movedim(y[..., 1:4], -1, 0) for y in ys])
    return sigma, u
