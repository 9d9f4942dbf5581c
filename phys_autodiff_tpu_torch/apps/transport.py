"""Semi-Lagrangian scalar transport on the grid (port of
phys_autodiff_tpu/apps/transport.py).

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

The z-sharded half (transport_sharded and the shard_local_* steps) runs on a
parallel.mesh.ZMesh: each rank holds its rows of sigma and u
(parallel.mesh.shard_rows gives them) and takes and returns its rows. Where
the JAX package sweeps x and y shard-locally and exchanges the swept
field's halo for the z sweep, the port exchanges the field's and u's halo
planes first (parallel/sharded.halo_extend_z_diff) and runs K8's slab form
on the extended slab (kernels/transport.transport_step_slab): the halo
planes take the same x and y sweeps their owner does, so the owned rows are
bitwise the single-device step's. A rollout through a frozen u exchanges
u's halo once. The sharded steps are differentiable across the ranks (the
halo's backward returns each halo plane's cotangent to its owner); every
rank runs the backward, and a loss is the sum of the ranks' parts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from phys_autodiff_tpu_torch.kernels import transport as ktr
from phys_autodiff_tpu_torch.kernels.transport import _axis_lerp, _clip
from phys_autodiff_tpu_torch.ops.stencil import shift
from phys_autodiff_tpu_torch.parallel.sharded import halo_extend_z_diff
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


# ---------------------------------------------------------------------------
# The z-sharded half
# ---------------------------------------------------------------------------


def _ring_bounds_halo_z(mesh, f: torch.Tensor, periodic: bool, xy_axes, halo_axis: int,
                        f_ext: torch.Tensor | None = None):
    """_ring_bounds of a rank's z slab f: the x and y reductions (xy_axes)
    on the halo-extended slab f_ext (exchanged here when not given; a step
    passes the slab it already extended), then the z reduction over each
    owned plane and its two neighbours along halo_axis. min and max are
    exact, so every cell's bounds are the single-device ones to the bit
    (JAX exchanges the x-y bounds' halos instead: two exchanges, the same
    values)."""
    if f_ext is None:
        f_ext = halo_extend_z_diff(mesh, f, periodic, halo_axis)
    lo, hi = _ring_bounds(f_ext, periodic, xy_axes)
    n = lo.shape[halo_axis] - 2

    def z3(x, op):
        return op(op(x.narrow(halo_axis, 0, n), x.narrow(halo_axis, 1, n)), x.narrow(halo_axis, 2, n))

    return z3(lo, torch.minimum), z3(hi, torch.maximum)


def _extended(mesh, g: GridSpec, fs: torch.Tensor, ul: torch.Tensor, u_ext):
    """(fs_ext, u_ext): u's halo exchanged unless given, and the fields'
    (the same tensor when the fields are u itself: K8's self-advection)."""
    if u_ext is None:
        u_ext = halo_extend_z_diff(mesh, ul, g.periodic, 1)
    return (u_ext if fs is ul else halo_extend_z_diff(mesh, fs, g.periodic, 1)), u_ext


def shard_local_transport_step_many(g: GridSpec, mesh):
    """The per-rank semi-Lagrangian step of a [C, nz_local, ny, nx] batch:
    step(fs, ul, dt, u_ext=None) -> fs'. The fields' and u's halo planes are
    exchanged (u's only when u_ext, its extended slab, is not given) and K8's
    slab form runs on the extended slab; bitwise the single-device
    transport_step_many's rows."""

    def step(fs, ul, dt, u_ext=None):
        fs_ext, u_ext = _extended(mesh, g, fs, ul, u_ext)
        return ktr.transport_step_slab(g, fs_ext, u_ext, dt)

    return step


def shard_local_maccormack_step_many(g: GridSpec, mesh, *, limit: bool = True):
    """The per-rank MacCormack step of a batch: each pass exchanges its own
    field's halo (as in JAX) and launches K8's slab form; the limiter's
    bounds come from the first pass's extended slab (_ring_bounds_halo_z).
    Bitwise the single-device maccormack_step_many's rows."""

    def step(fs, ul, dt, u_ext=None):
        fs_ext, u_ext = _extended(mesh, g, fs, ul, u_ext)
        fwd = ktr.transport_step_slab(g, fs_ext, u_ext, dt)
        bwd = ktr.transport_step_slab(g, halo_extend_z_diff(mesh, fwd, g.periodic, 1), u_ext, -dt)
        out = fwd + 0.5 * (fs - bwd)
        if limit:
            lo, hi = _ring_bounds_halo_z(mesh, fs, g.periodic, (3, 2), 1, f_ext=fs_ext)
            out = _clip(out, lo, hi)
        return out

    return step


def _scalar(step_many):
    return lambda s, ul, dt, u_ext=None: step_many(s[None], ul, dt, u_ext)[0]


def shard_local_transport_step(g: GridSpec, mesh):
    """The per-rank semi-Lagrangian step of one scalar [nz_local, ny, nx]:
    step(s, ul, dt, u_ext=None) -> s' (K8's slab form, C = 1)."""
    return _scalar(shard_local_transport_step_many(g, mesh))


def shard_local_maccormack_step(g: GridSpec, mesh, *, limit: bool = True):
    """The per-rank MacCormack step of one scalar (two K8 slab launches)."""
    return _scalar(shard_local_maccormack_step_many(g, mesh, limit=limit))


def make_shard_local_step(g: GridSpec, cfg: TransportConfig, mesh):
    """The shard-local counterpart of make_step:
    step(s_local, u_local, dt, u_ext=None) -> s_local'."""
    if cfg.scheme == "semi_lagrangian":
        return shard_local_transport_step(g, mesh)
    if cfg.scheme == "maccormack":
        return shard_local_maccormack_step(g, mesh, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def make_shard_local_step_many(g: GridSpec, cfg: TransportConfig, mesh):
    """The shard-local counterpart of make_step_many."""
    if cfg.scheme == "semi_lagrangian":
        return shard_local_transport_step_many(g, mesh)
    if cfg.scheme == "maccormack":
        return shard_local_maccormack_step_many(g, mesh, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def transport_sharded(g: GridSpec, sigma_local: torch.Tensor, u_local: torch.Tensor, cfg: TransportConfig, mesh):
    """The multi-rank rollout through a FROZEN velocity: sigma_local
    [nz_local, ny, nx] and u_local [3, nz_local, ny, nx], this rank's rows.
    u's halo is exchanged once; each step exchanges sigma's (twice for
    MacCormack) and launches K8's slab form. Bitwise the single-device
    transport's rows. Returns (this rank's rows of sigma_final, the max CFL
    of the whole grid: an all-reduce max, exact, so the single-device
    value to the bit)."""
    _, nzl = mesh.rows(g.nz)  # raises for an uneven split, before any exchange
    if tuple(sigma_local.shape) != (nzl, g.ny, g.nx) or tuple(u_local.shape) != (3, nzl, g.ny, g.nx):
        raise ValueError(f"expected this rank's rows {(nzl, g.ny, g.nx)} and {(3, nzl, g.ny, g.nx)}, got "
                         f"{tuple(sigma_local.shape)} and {tuple(u_local.shape)}")
    step = make_shard_local_step(g, cfg, mesh)
    u_ext = halo_extend_z_diff(mesh, u_local, g.periodic, 1)
    s = sigma_local
    for _ in range(cfg.steps):
        s = step(s, u_local, cfg.dt, u_ext)
    return s, mesh.all_reduce(max_cfl(g, u_local, cfg.dt), op=dist.ReduceOp.MAX)
