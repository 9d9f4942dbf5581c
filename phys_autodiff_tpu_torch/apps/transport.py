"""Semi-Lagrangian scalar transport on the grid (port of the single-device
half of phys_autodiff_tpu/apps/transport.py).

To advance sigma by dt through velocity u, backtrace each cell's
characteristic to its departure point x - u(x) dt and interpolate sigma
there. Under the CFL condition (|u| dt <= h per axis) every departure point
lies within the +-1-neighbour ring, so trilinear interpolation factorizes
into three axis sweeps lerp(f_lo, f_hi, w) with f_lo / f_hi chosen from the
shifts {-1, 0, +1}: no gathers (kernels/transport.py, K8 on the card). The
sweeps apply each cell's own per-axis offset (dimensional splitting): for
constant u this is exactly trilinear interpolation at the departure point,
for varying u it differs by O(dt^2 grad u), the order of the backtrace
itself. Boundaries follow ops/stencil.shift (periodic wrap / edge clamp).

The interpolation is a convex combination of neighbour values, so the
discrete max principle holds: min(f) <= step(f) <= max(f).

Every step on a CUDA tensor launches K8 (transport_step, transport_step_many
and MacCormack's two passes); on CPU tensors the same functions run K8's
plain version. Rollouts are Python loops (the JAX lax.scans).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import transport as ktr
from phys_autodiff_tpu_torch.kernels.transport import _axis_lerp, _clip
from phys_autodiff_tpu_torch.ops.stencil import shift
from phys_autodiff_tpu_torch.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    dt: float = 1e-3
    steps: int = 1
    # Offsets are always clipped into [-1, 1] cells; the rollouts return the
    # pre-clip max CFL so callers can assert <= 1. check_cfl is the JAX
    # package's keyword (apps/transport.py:61) and changes nothing here: the
    # clip and the returned CFL are unconditional in both packages.
    check_cfl: bool = True
    scheme: str = "semi_lagrangian"  # "semi_lagrangian" | "maccormack"
    mc_limit: bool = True  # clamp the MacCormack correction into the
    # neighbour-ring bounds (keeps the discrete max principle)


def transport_step(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One semi-Lagrangian step: sigma(x, t+dt) = sigma(x - u dt, t), offsets
    clipped to one cell per axis. sigma [nz, ny, nx]; u [3, nz, ny, nx]; dt a
    Python number. K8 on the card; differentiable."""
    assert tuple(u.shape) == (3,) + tuple(sigma.shape), (u.shape, sigma.shape)
    return ktr.transport_step_fused(g, sigma, u, dt)


def transport_step_bf16(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """bf16-I/O tier of transport_step: sigma and u in bfloat16, the sweeps
    in bf16 arithmetic, the result bfloat16. The offsets are computed in f32
    from the upcast velocity, then the lerp weights round to bf16, so each
    sweep is a convex combination in bf16 (1e-2-class error against the f32
    step). Plain PyTorch: the JAX package runs this tier in XLA."""
    assert tuple(u.shape) == (3,) + tuple(sigma.shape), (u.shape, sigma.shape)
    sigma = sigma.to(torch.bfloat16)
    dx, dy, dz = ktr.offsets(g, u.to(torch.bfloat16), dt)
    per = g.periodic
    out = _axis_lerp(sigma, dx, 2, per)
    out = _axis_lerp(out, dy, 1, per)
    return _axis_lerp(out, dz, 0, per)


def transport_step_many(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """Advect a [C, nz, ny, nx] batch of scalars through one velocity field
    in a single pass (shared offsets); bitwise equal per channel to
    transport_step. Used by the Euler solver's velocity self-advection."""
    assert fields.ndim == 4 and tuple(u.shape) == (3,) + tuple(fields.shape[1:]), (fields.shape, u.shape)
    return ktr.transport_step_many_fused(g, fields, u, dt)


def _ring_bounds(f: torch.Tensor, periodic: bool, axes=(2, 1, 0)):
    """(min, max) of f over each cell's 3x3x3 neighbour ring, as separable
    one-axis reductions over `axes`. Under CFL <= 1 a split step at cell i
    only reads {i-1, i, i+1} per axis, so this ring is the convex hull of
    the values one step can draw from: the MacCormack limiter's bound."""
    lo = hi = f
    for ax in axes:
        lo = torch.minimum(torch.minimum(shift(lo, -1, ax, periodic), lo), shift(lo, +1, ax, periodic))
        hi = torch.maximum(torch.maximum(shift(hi, -1, ax, periodic), hi), shift(hi, +1, ax, periodic))
    return lo, hi


def maccormack_step(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt, *, limit: bool = True) -> torch.Tensor:
    """One second-order MacCormack (BFECC-family) step (Selle et al. 2008):

        fwd = A_dt(sigma), bwd = A_{-dt}(fwd), out = fwd + (sigma - bwd) / 2

    with limit=True clamped into the 3x3x3 neighbour-ring bounds of sigma,
    which restores the discrete max principle. Two K8 launches."""
    fwd = transport_step(g, sigma, u, dt)
    bwd = transport_step(g, fwd, u, -dt)
    out = fwd + 0.5 * (sigma - bwd)
    if limit:
        lo, hi = _ring_bounds(sigma, g.periodic)
        out = _clip(out, lo, hi)
    return out


def maccormack_step_many(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt, *,
                         limit: bool = True) -> torch.Tensor:
    """maccormack_step for a [C, nz, ny, nx] batch (two K8 launches)."""
    fwd = transport_step_many(g, fields, u, dt)
    bwd = transport_step_many(g, fwd, u, -dt)
    out = fwd + 0.5 * (fields - bwd)
    if limit:
        lo, hi = _ring_bounds(fields, g.periodic, axes=(3, 2, 1))
        out = _clip(out, lo, hi)
    return out


def make_step(g: GridSpec, cfg: TransportConfig):
    """step(sigma, u, dt) -> sigma for cfg.scheme."""
    if cfg.scheme == "semi_lagrangian":
        return lambda s, u, dt: transport_step(g, s, u, dt)
    if cfg.scheme == "maccormack":
        return lambda s, u, dt: maccormack_step(g, s, u, dt, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def make_step_many(g: GridSpec, cfg: TransportConfig):
    """Batched [C, nz, ny, nx] counterpart of make_step."""
    if cfg.scheme == "semi_lagrangian":
        return lambda fs, u, dt: transport_step_many(g, fs, u, dt)
    if cfg.scheme == "maccormack":
        return lambda fs, u, dt: maccormack_step_many(g, fs, u, dt, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def max_cfl(g: GridSpec, u: torch.Tensor, dt) -> torch.Tensor:
    """max over axes of |u| dt / h (a 0-dim tensor): the step is
    interpolation-exact only when this is <= 1."""
    dt = float(np.float32(dt))
    per_axis = [torch.max(torch.abs(u[a])) * dt / float(np.float32(h)) for a, h in enumerate((g.hx, g.hy, g.hz))]
    return torch.maximum(per_axis[0], torch.maximum(per_axis[1], per_axis[2]))


def transport(g: GridSpec, sigma0: torch.Tensor, u: torch.Tensor, cfg: TransportConfig):
    """Roll sigma forward cfg.steps steps through a FROZEN velocity field.
    Returns (sigma_final, max_cfl); assert max_cfl <= 1 for an
    interpolation-exact rollout."""
    cfl = max_cfl(g, u, cfg.dt)
    step = make_step(g, cfg)
    s = sigma0
    for _ in range(cfg.steps):
        s = step(s, u, cfg.dt)
    return s, cfl


def velocity_grid_fn_from_model(g: GridSpec, model_cfg, params):
    """vel_at(t) -> [3, nz, ny, nx] for transport_time_dependent from any
    trained field model (MLP or encoded family): one grid inference per
    step, channels moved to the physics layout."""
    from phys_autodiff_tpu_torch.models.sample import grid_infer_any

    def vel_at(t):
        y = grid_infer_any(g, model_cfg, params, t)
        return torch.movedim(y[..., 1:4], -1, 0)

    return vel_at


def transport_time_dependent(g: GridSpec, sigma0: torch.Tensor, vel_at, t0, cfg: TransportConfig):
    """transport() with a time-dependent velocity vel_at(t) -> [3, nz, ny, nx]
    evaluated once a step at t0 + k dt (float32). Returns (sigma_final, the
    max CFL over the steps)."""
    dt32, t0 = np.float32(cfg.dt), np.float32(t0)
    step = make_step(g, cfg)
    s = sigma0
    cfls = []
    for k in range(cfg.steps):
        u = vel_at(t0 + dt32 * np.float32(k))
        cfls.append(max_cfl(g, u, cfg.dt))
        s = step(s, u, cfg.dt)
    return s, torch.max(torch.stack(cfls))
