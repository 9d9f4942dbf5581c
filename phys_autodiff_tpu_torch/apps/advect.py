"""Tracer-particle advection through a learned velocity field (port of
phys_autodiff_tpu/apps/advect.py).

Given any trained field model (coordinate MLP, encoded field) or a frozen grid
snapshot, advance P tracer particles dx/dt = u(x, t) with explicit Euler or
RK2 (midpoint); the particles advance in lockstep as [P, 3] tensor ops.

State lives in continuous grid-INDEX coordinates (models/sample.py), where the
periodic topology has period n per axis; physical velocity converts to index
velocity by 1/h per axis. Periodic boundaries wrap, clamp boxes the particle
into [0, n-1]. Plain PyTorch; the device follows the positions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from phys_autodiff_tpu_torch.models import sample
from phys_autodiff_tpu_torch.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class AdvectConfig:
    steps: int = 100
    dt: float = 1e-3
    method: str = "rk2"  # "euler" | "rk2" (midpoint)
    record_every: int = 0  # 0: final positions only; k > 0: also the
    # [steps // k, P, 3] trajectory (index coords)


# A velocity function maps (pts_idx [P, 3], t) -> u [P, 3] in PHYSICAL units.
VelocityFn = Callable[[torch.Tensor, np.float32], torch.Tensor]


def velocity_fn_from_model(g: GridSpec, model_cfg, params, **kw) -> VelocityFn:
    """Velocity by direct model evaluation at the particle positions (exact,
    time-dependent, differentiable in the params). The unit coords are
    clamped to [0, 1]: the periodic seam band (index in (n-1, n)) evaluates
    at the u = 1 face. kw goes to sample.evaluate_points."""

    def vel(pts_idx, t):
        pts_unit = torch.clamp(sample.index_to_unit(g, pts_idx), 0.0, 1.0)
        return sample.evaluate_points(model_cfg, params, pts_unit, t, **kw)[..., 1:4]

    return vel


def velocity_fn_from_grid(g: GridSpec, u_grid: torch.Tensor) -> VelocityFn:
    """Velocity by trilinear sampling of a frozen [3, nz, ny, nx] snapshot;
    the time argument is ignored."""
    assert tuple(u_grid.shape) == (3,) + g.shape, u_grid.shape

    def vel(pts_idx, t):
        del t
        return sample.trilinear_sample(u_grid, pts_idx, g)

    return vel


def _wrap(g: GridSpec, pts_idx: torch.Tensor) -> torch.Tensor:
    n = torch.tensor([g.nx, g.ny, g.nz], dtype=torch.float32, device=pts_idx.device)
    if g.periodic:
        return torch.remainder(pts_idx, n)
    return torch.minimum(torch.maximum(pts_idx, torch.zeros_like(n)), n - 1.0)


def advect(g: GridSpec, vel_fn: VelocityFn, pts0_idx: torch.Tensor, t0, cfg: AdvectConfig):
    """Roll P particles forward cfg.steps steps of size cfg.dt.

    pts0_idx: [P, 3] initial positions in grid-index coords (x, y, z).
    Returns the final positions [P, 3], or (final, trajectory) when
    cfg.record_every > 0."""
    if cfg.method not in ("euler", "rk2"):
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.record_every and cfg.steps % cfg.record_every:
        raise ValueError("steps must be a multiple of record_every")
    inv_h = torch.tensor([1.0 / g.hx, 1.0 / g.hy, 1.0 / g.hz], dtype=torch.float32, device=pts0_idx.device)
    dt, t0 = np.float32(cfg.dt), np.float32(t0)
    half_dt = np.float32(0.5) * dt

    def step(pts, k):
        t = t0 + dt * np.float32(k)
        v1 = vel_fn(pts, t) * inv_h  # index-space velocity
        if cfg.method == "euler":
            nxt = pts + float(dt) * v1
        else:  # rk2 midpoint
            mid = _wrap(g, pts + float(half_dt) * v1)
            v2 = vel_fn(mid, t + half_dt) * inv_h
            nxt = pts + float(dt) * v2
        return _wrap(g, nxt)

    pts = _wrap(g, pts0_idx.to(torch.float32))
    frames = []
    for k in range(cfg.steps):
        pts = step(pts, k)
        if cfg.record_every and (k + 1) % cfg.record_every == 0:
            frames.append(pts)
    if cfg.record_every and cfg.record_every > 0:
        return pts, torch.stack(frames)
    return pts


def advect_sharded(g: GridSpec, vel_fn: VelocityFn, pts0_idx: torch.Tensor, t0, cfg: AdvectConfig, mesh):
    """Advection with the particles split over the ranks of a ZMesh and the
    velocity model replicated: pure data parallelism. pts0_idx [P, 3] holds
    every particle (as the JAX function takes the whole array); this rank
    advects its block, rows [rank P/n, (rank + 1) P/n), through the same
    advect(), with no collective, and returns advect()'s outputs for that
    block (on the mesh's device). P must divide over the ranks (pad with
    dummies otherwise), else ValueError."""
    p = pts0_idx.shape[0]
    if p % mesh.size:
        raise ValueError(f"particle count {p} must be divisible by the {mesh.size} ranks")
    b = p // mesh.size
    return advect(g, vel_fn, pts0_idx[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device), t0, cfg)


def make_advect_fn(g: GridSpec, vel_fn: VelocityFn, t0, cfg: AdvectConfig):
    """pts -> advect(g, vel_fn, pts, t0, cfg) for repeated calls with new
    initial positions (the JAX package's compile-once form; nothing is
    compiled here)."""
    return lambda pts: advect(g, vel_fn, pts, t0, cfg)
