"""Axis-separable Fourier-feature (positional) encoding (port of
phys_autodiff_tpu/models/fourier.py).

    gamma(v) = [v?, sin(pi 2^0 v), cos(pi 2^0 v), ..., sin(pi 2^{K-1} v),
                cos(pi 2^{K-1} v)]   per axis, concatenated over (x, y, z)

The encoding has no parameters: `init_params` returns an empty float32
tensor, so the encoded-field params keep their {"tables", W1, ...} shape
and the NGP backward kernel skips its encoder cotangent. On a regular grid
each channel depends on one axis, so `encode_grid*` evaluate three small
per-axis feature matrices and broadcast them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.models.coords import _axis_coord
from phys_autodiff_tpu_torch.utils.config import CoordNorm


@dataclasses.dataclass(frozen=True)
class FourierEncodingConfig:
    """NeRF-style axis-aligned positional encoding over [0, 1] coordinates.

    num_frequencies: octaves per axis (frequencies pi * 2^k, k < K).
    include_input: prepend the raw coordinate channel per axis.
    """

    num_frequencies: int = 6
    include_input: bool = True

    @property
    def axis_dim(self) -> int:
        return (1 if self.include_input else 0) + 2 * self.num_frequencies

    @property
    def out_dim(self) -> int:
        return 3 * self.axis_dim


def init_params(cfg: FourierEncodingConfig, seed: int = 0, device="cuda") -> torch.Tensor:
    """No parameters: an empty float32 tensor on `device`."""
    del cfg, seed
    return torch.zeros((0,), dtype=torch.float32, device=device)


def schedule_meta(cfg: FourierEncodingConfig) -> dict:
    """Checkpoint fingerprint; its keys differ from the hash family's, so a
    checkpoint of one family is refused by the other."""
    return {
        "fourier_num_frequencies": cfg.num_frequencies,
        "fourier_include_input": cfg.include_input,
    }


def _axis_features(cfg: FourierEncodingConfig, v: torch.Tensor) -> torch.Tensor:
    """v [...] -> [..., axis_dim], frequencies as float32 constants."""
    v = v.to(torch.float32)
    feats = [v] if cfg.include_input else []
    for k in range(cfg.num_frequencies):
        w = float(np.float32(np.pi * (2.0**k)))
        feats.append(torch.sin(w * v))
        feats.append(torch.cos(w * v))
    return torch.stack(feats, dim=-1)


def encode(cfg: FourierEncodingConfig, coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] in [0, 1] -> [..., out_dim], channels axis-major
    [x-features | y-features | z-features]. Safe at any batch size."""
    return torch.cat([_axis_features(cfg, coords[..., a]) for a in range(3)], dim=-1)


def _axis_vectors(cfg: FourierEncodingConfig, g, device):
    """The per-axis feature matrices [nx, C], [ny, C], [nz, C] on the
    grid's v/(n-1) coordinates (a degenerate axis has coordinate 0)."""
    return tuple(
        _axis_features(cfg, _axis_coord(n, CoordNorm.ZeroToOne, device)) for n in (g.nx, g.ny, g.nz)
    )


def encode_grid(cfg: FourierEncodingConfig, g, device="cuda") -> torch.Tensor:
    """Every point of a regular grid -> [nz, ny, nx, out_dim]."""
    nz, ny, nx = g.shape
    fx, fy, fz = _axis_vectors(cfg, g, device)
    c = cfg.axis_dim
    return torch.cat(
        [
            fx[None, None, :, :].expand(nz, ny, nx, c),
            fy[None, :, None, :].expand(nz, ny, nx, c),
            fz[:, None, None, :].expand(nz, ny, nx, c),
        ],
        dim=-1,
    )


def encode_grid_zcf(cfg: FourierEncodingConfig, g, device="cuda") -> torch.Tensor:
    """encode_grid in the z-major channel-first layout [nz, out_dim, ny, nx]
    of the NGP backward kernel."""
    nz, ny, nx = g.shape
    fx, fy, fz = _axis_vectors(cfg, g, device)
    c = cfg.axis_dim
    return torch.cat(
        [
            fx.T[None, :, None, :].expand(nz, c, ny, nx),
            fy.T[None, :, :, None].expand(nz, c, ny, nx),
            fz[:, :, None, None].expand(nz, c, ny, nx),
        ],
        dim=1,
    )


def encode_grid_zcf_rows(cfg: FourierEncodingConfig, g, rows: torch.Tensor, device="cuda") -> torch.Tensor:
    """encode_grid_zcf restricted to the given global z rows ->
    [len(rows), out_dim, ny, nx]. Only the z features vary a row; taking the
    z coordinate at `rows` before the sin / cos keeps each row the matching
    full row's, bit for bit."""
    ny, nx = g.ny, g.nx
    k = rows.shape[0]
    fx, fy, _ = _axis_vectors(cfg, g, device)
    cz = _axis_coord(g.nz, CoordNorm.ZeroToOne, device)
    fz = _axis_features(cfg, cz[rows.to(cz.device)])  # [K, C]
    c = cfg.axis_dim
    return torch.cat(
        [
            fx.T[None, :, None, :].expand(k, c, ny, nx),
            fy.T[None, :, :, None].expand(k, c, ny, nx),
            fz[:, :, None, None].expand(k, c, ny, nx),
        ],
        dim=1,
    )
