"""The encoded field: a multiresolution hash encoding (Instant-NGP, Mueller
et al. 2022) and a decode head, written out.

Level l has resolution N_l = floor(exp(lerp(ln N_min, ln N_max, l / (L - 1)))
+ 0.5) and a lattice of (N_l + 1)^3 corners of F features. A point u in
[0, 1]^3 sits at u (N_l - 1) in lattice units; its feature is the trilinear
interpolation of the 8 corners around it. A level whose lattice has more
corners than the table's T entries is stored densely ("dense": {"l<l>":
[N+1, N+1, N+1, F]}, indexed [z, y, x]) when `dense_oversubscribed` is
set; the others hash corner (i, j, k) to entry (i ^ 2654435761 j ^
805459861 k) mod T of their row of "hash" [levels, T, F] (uint32
products). The levels concatenate, level-major, into LF = L F features.

The head: [sigma, ux, uy, uz] = relu([enc, t] W1 + b1) W2 + b2, W1 [LF + 1,
H], the time channel the raw t.

On a grid the interpolation is separable: the reference interpolates
along z (only the planes asked for), then y, then x, which is the same
sum of eight weighted corners.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.grid import Grid
from portbench.reference.precision import Precision, matmul

_PRIMES = (1, 2654435761, 805459861)


def resolutions(enc: dict) -> list[int]:
    n = enc["num_levels"]
    if n == 1:
        return [enc["base_resolution"]]
    ln = np.linspace(np.log(enc["base_resolution"]), np.log(enc["max_resolution"]), n)
    return [int(v) for v in np.floor(np.exp(ln) + 0.5)]


def dense_levels(enc: dict) -> list[int]:
    if not enc.get("dense_oversubscribed", False):
        return []
    t = 1 << enc["log2_table_size"]
    return [l for l, r in enumerate(resolutions(enc)) if (r + 1) ** 3 > t]


def _lattice(enc: dict, tables: dict, level: int, r: int) -> torch.Tensor:
    """The level's corner values [r + 1, r + 1, r + 1, F], [z, y, x]."""
    dense = dense_levels(enc)
    if level in dense:
        return tables["dense"][f"l{level}"]
    row = [l for l in range(enc["num_levels"]) if l not in dense].index(level)
    table = tables["hash"][row]
    i = torch.arange(r + 1, dtype=torch.int64, device=table.device)
    hx, hy, hz = (i * p for p in _PRIMES)
    h = (hz[:, None, None] ^ hy[None, :, None] ^ hx[None, None, :]) & (table.shape[0] - 1)
    return table[h]


def _weights(n: int, r: int, device):
    """Lower corner index and weight of the upper corner of n grid nodes."""
    if n == 1:
        return torch.zeros(1, dtype=torch.int64, device=device), torch.zeros(1, dtype=torch.float64, device=device)
    pos = np.arange(n, dtype=np.float64) / (n - 1) * (r - 1)
    i0 = np.floor(pos).astype(np.int64)
    return torch.tensor(i0, device=device), torch.tensor(pos - i0, device=device)


def _lerp(c: torch.Tensor, axis: int, i0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    shape = [1] * c.dim()
    shape[axis] = -1
    w = w.to(c.dtype).reshape(shape)
    return c.index_select(axis, i0) * (1.0 - w) + c.index_select(axis, i0 + 1) * w


def encode(enc: dict, tables: dict, g: Grid, rows: torch.Tensor) -> torch.Tensor:
    """[R, ny, nx, LF] encoding of the given z planes."""
    outs = []
    dev = rows.device
    for level, r in enumerate(resolutions(enc)):
        c = _lattice(enc, tables, level, r)
        iz, wz = _weights(g.nz, r, dev)
        iy, wy = _weights(g.ny, r, dev)
        ix, wx = _weights(g.nx, r, dev)
        c = _lerp(c, 0, iz[rows], wz[rows])
        c = _lerp(c, 1, iy, wy)
        outs.append(_lerp(c, 2, ix, wx))
    return torch.cat(outs, dim=-1)


def _head(params: dict, e: torch.Tensor, t: float, prec: Precision) -> torch.Tensor:
    x = torch.cat([e, e.new_full(e.shape[:-1] + (1,), t)], dim=-1)
    a1 = torch.clamp_min(matmul(x, params["W1"], prec) + params["b1"], 0.0)
    return matmul(a1, params["W2"], prec) + params["b2"]


def field(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, t: float, prec: Precision) -> torch.Tensor:
    """[R, ny, nx, 4] of the given planes at time t."""
    return _head(params, encode(cfg["encoding"], params["tables"], g, rows), t, prec)


def fields(cfg: dict, params: dict, g: Grid, rows: torch.Tensor, ts, prec: Precision):
    """(sigma [S, R, ny, nx], u [S, 3, R, ny, nx]) at the times ts, from one
    encoding of the planes."""
    e = encode(cfg["encoding"], params["tables"], g, rows)
    ys = torch.stack([_head(params, e, t, prec) for t in ts])
    return ys[..., 0], torch.movedim(ys[..., 1:4], -1, 1)


def rows_per_block(cfg: dict, g: Grid, budget_bytes: float) -> int:
    """Planes a block may hold: the head's hidden activations of three
    slices and the encoding, kept for the backward (float64)."""
    lf = cfg["encoding"]["num_levels"] * cfg["encoding"]["features_per_level"]
    per_plane = g.ny * g.nx * 8 * (3 * 3 * cfg["hidden"] + 4 * lf)
    return max(1, int(budget_bytes // per_plane) - 2)
