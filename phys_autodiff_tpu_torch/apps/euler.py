"""Incompressible Euler "smoke" solver: advect / force / project (port of
phys_autodiff_tpu/apps/euler.py).

A stable-fluids stepper assembled from the framework's primitives:

  1. self-advect velocity   apps.transport's semi-Lagrangian (or limited
                            MacCormack) step on all three components in one
                            batched pass (K8, C = 3, on the card),
  2. body forces            buoyancy b * sigma * z_hat, vorticity
                            confinement, EulerSource forces,
  3. diffuse (optional)     ops.diffusion implicit viscosity,
  4. project                ops.projection (FFT on periodic boxes, CGNR
                            under clamp; masked CGNR with obstacles),
  5. advect the density     through the projected velocity (K8, C = 1).

Rollouts are Python loops whose per-step diagnostics stay device tensors
(no host wait a step). Every stage is differentiable by autograd, so
rollout_loss's gradient is the discrete adjoint of the whole rollout
(K8's backward is its plain version's VJP; the CG solves differentiate
implicitly, as jax.scipy.sparse.linalg.cg does).

rollout_sharded is the z-sharded rollout on a parallel.mesh.ZMesh: each
rank steps its rows with explicit collectives (the transport on K8's slab
form, the pencil FFT of parallel/spectral.py), and with a fluid mask the
masked CGNR projection on the shards.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from phys_autodiff_tpu_torch.apps.transport import (
    TransportConfig,
    make_shard_local_step,
    make_shard_local_step_many,
    make_step,
    make_step_many,
    max_cfl,
)
from phys_autodiff_tpu_torch.ops import diagnostics, diffusion, obstacles, projection
from phys_autodiff_tpu_torch.ops.cg import cg
from phys_autodiff_tpu_torch.ops.stencil import central_diff, inv2h_f32, shift
from phys_autodiff_tpu_torch.parallel import spectral
from phys_autodiff_tpu_torch.parallel.sharded import halo_extend_z_diff
from phys_autodiff_tpu_torch.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    dt: float = 1e-3
    steps: int = 1
    buoyancy: float = 0.0  # force = buoyancy * sigma along +z
    viscosity: float = 0.0  # implicit momentum diffusion (ops.diffusion)
    diffusivity: float = 0.0  # implicit density diffusion
    projection: str = "auto"  # "auto" | "fft" | "cg" | "none"
    cg_maxiter: int = 200
    cg_tol: float = 1e-6
    advection: str = "semi_lagrangian"  # "semi_lagrangian" | "maccormack"
    confinement: float = 0.0  # vorticity-confinement strength epsilon
    # (force = eps * h * N x omega, Fedkiw/Stam/Jensen 2001)
    remat: bool = False  # recompute each step's interior in the backward
    # (torch.utils.checkpoint): the backward then stores only the carried
    # (sigma, u) a step; forward values and gradients are unchanged


class EulerState(NamedTuple):
    sigma: torch.Tensor  # [nz, ny, nx]
    u: torch.Tensor  # [3, nz, ny, nx]


class EulerSource(NamedTuple):
    """Continuous sources: smoke injection d sigma/dt = sigma_rate
    [nz, ny, nx] and a momentum body force [3, nz, ny, nx] (pre-projection)."""

    sigma_rate: torch.Tensor
    force: torch.Tensor

    @staticmethod
    def zeros(g: GridSpec, device="cuda") -> "EulerSource":
        return EulerSource(torch.zeros(g.shape, device=device), torch.zeros((3,) + g.shape, device=device))


def _project(g: GridSpec, u: torch.Tensor, cfg: EulerConfig, mask=None) -> torch.Tensor:
    mode = cfg.projection
    if mask is not None and mode != "none":
        # obstacles have no fast diagonalization: the masked CGNR solve
        return obstacles.project_masked(g, u, mask, maxiter=cfg.cg_maxiter, tol=cfg.cg_tol)
    if mode == "auto":
        mode = "fft" if g.periodic else "cg"
    if mode == "fft":
        return projection.project_fft(g, u)
    if mode == "cg":
        return projection.project_cg(g, u, maxiter=cfg.cg_maxiter, tol=cfg.cg_tol)
    if mode == "none":
        return u
    raise ValueError(f"unknown projection mode {cfg.projection!r}")


def vorticity_confinement(g: GridSpec, u: torch.Tensor, eps: float) -> torch.Tensor:
    """Vorticity-confinement body force f = eps * h * (N x omega): omega =
    curl u, N = normalized grad |omega|; h the geometric-mean cell size.
    Returns [3, nz, ny, nx]; zero for irrotational fields."""
    w = diagnostics.curl(g, u)
    # sqrt(s + tiny): d/ds sqrt(s) is infinite at s = 0 and would poison
    # gradients through the rollout; the floor keeps the force zero for
    # irrotational fields
    wmag = torch.sqrt(torch.sum(w * w, dim=0) + float(np.float32(1e-30)))
    eta = projection.grad(g, wmag)
    n = eta / (torch.sqrt(torch.sum(eta * eta, dim=0)) + float(np.float32(1e-20)))
    h = float((g.hx * g.hy * g.hz) ** (1.0 / 3.0))
    s = float(np.float32(eps * h))
    return s * torch.stack([
        n[1] * w[2] - n[2] * w[1],
        n[2] * w[0] - n[0] * w[2],
        n[0] * w[1] - n[1] * w[0],
    ])


def _advect(g: GridSpec, cfg: EulerConfig):
    return make_step(g, TransportConfig(scheme=cfg.advection))


def _advect_many(g: GridSpec, cfg: EulerConfig):
    """Batched advection for the velocity self-advection: one pass over
    [3, nz, ny, nx] with shared offsets (one K8 launch, C = 3)."""
    return make_step_many(g, TransportConfig(scheme=cfg.advection))


def euler_step(g: GridSpec, state: EulerState, cfg: EulerConfig, *, mask=None,
               source: EulerSource | None = None) -> EulerState:
    """One advect / force / project step. The velocity self-advection
    backtraces through the pre-step velocity; the density advects through
    the post-projection velocity.

    `mask` ([nz, ny, nx], 1 fluid, 0 solid) adds solid obstacles: every
    stage's output is re-masked (no-slip), forces act on fluid cells only,
    the projection is the masked CGNR solve, and the density is zero in
    solids. `source` (EulerSource) adds emitters: the force joins the body
    forces before the projection, the injection sigma += dt * rate lands
    after the density transport."""
    sigma, u = state
    dt = float(np.float32(cfg.dt))
    advect = _advect(g, cfg)
    if mask is not None:
        u = obstacles.apply_no_slip(u, mask)
        # mask the incoming density too, so solid cells stay exactly zero
        sigma = obstacles.apply_no_slip(sigma, mask)
    # 1. self-advection through the frozen pre-step u, all 3 components
    u_adv = _advect_many(g, cfg)(u, u, cfg.dt)
    if mask is not None:
        u_adv = obstacles.apply_no_slip(u_adv, mask)
    # 2. body forces (pre-projection: the projection removes the divergence
    #    they inject)
    if cfg.buoyancy != 0.0:
        fz = float(np.float32(cfg.buoyancy)) * sigma
        if mask is not None:
            fz = fz * mask
        u_adv = torch.cat([u_adv[:2], (u_adv[2] + dt * fz)[None]])
    if cfg.confinement != 0.0:
        conf = vorticity_confinement(g, u_adv, cfg.confinement)
        if mask is not None:
            conf = obstacles.apply_no_slip(conf, mask)
        u_adv = u_adv + dt * conf
    if source is not None:
        f = source.force
        if mask is not None:
            f = f * mask[None]
        u_adv = u_adv + dt * f
    # 3. implicit viscosity (diffuse, then project)
    if cfg.viscosity != 0.0:
        u_adv = diffusion.diffuse(g, u_adv, cfg.viscosity, cfg.dt)
        if mask is not None:
            u_adv = obstacles.apply_no_slip(u_adv, mask)
    # 4. pressure projection
    u_new = _project(g, u_adv, cfg, mask)
    # 5. density transport through the divergence-free field, the sources,
    #    implicit scalar diffusion
    sigma_new = advect(sigma, u_new, cfg.dt)
    if source is not None:
        rate = source.sigma_rate
        if mask is not None:
            rate = rate * mask
        sigma_new = sigma_new + dt * rate
    if cfg.diffusivity != 0.0:
        sigma_new = diffusion.diffuse(g, sigma_new, cfg.diffusivity, cfg.dt)
    if mask is not None:
        sigma_new = sigma_new * mask
    return EulerState(sigma_new, u_new)


def rollout(g: GridSpec, state0: EulerState, cfg: EulerConfig, *, mask=None, source: EulerSource | None = None):
    """cfg.steps Euler steps. Returns (final EulerState, diagnostics): a
    dict of [steps] tensors max_cfl, max_abs_div (interior fluid cells only
    when `mask` is given: ops.obstacles.fluid_divergence) and
    kinetic_energy, kept on the device (no host wait a step).

    With cfg.remat each step is checkpointed (torch.utils.checkpoint): the
    backward stores one (sigma, u) pair a step and recomputes the rest."""

    def step_fn(sigma, u):
        return tuple(euler_step(g, EulerState(sigma, u), cfg, mask=mask, source=source))

    if mask is None:
        div_of = lambda u: projection.projection_residual(g, u)  # noqa: E731
    else:
        div_of = lambda u: obstacles.fluid_divergence(g, u, mask)  # noqa: E731
    state = tuple(state0)
    cfls, divs, kes = [], [], []
    for _ in range(cfg.steps):
        if cfg.remat and torch.is_grad_enabled():
            state = checkpoint(step_fn, *state, use_reentrant=False)
        else:
            state = step_fn(*state)
        u = state[1]
        cfls.append(max_cfl(g, u, cfg.dt))
        divs.append(div_of(u))
        kes.append(diagnostics.kinetic_energy(u))
    diag = {"max_cfl": torch.stack(cfls), "max_abs_div": torch.stack(divs), "kinetic_energy": torch.stack(kes)}
    return EulerState(*state), diag


def rollout_loss(g: GridSpec, u0: torch.Tensor, sigma0: torch.Tensor, target_sigma: torch.Tensor,
                 cfg: EulerConfig, *, mask=None, source: EulerSource | None = None) -> torch.Tensor:
    """MSE between the density after a cfg.steps rollout from (sigma0, u0)
    and target_sigma: the differentiable-simulation objective. u0 passes
    through cfg's projection first."""
    u0 = _project(g, u0, cfg, mask)
    final, _ = rollout(g, EulerState(sigma0, u0), cfg, mask=mask, source=source)
    d = final.sigma - target_sigma
    return torch.mean(d * d)


def fit_initial_velocity(g: GridSpec, sigma0: torch.Tensor, target_sigma: torch.Tensor, cfg: EulerConfig, *,
                         u0_init: torch.Tensor | None = None, opt_steps: int = 50, learning_rate: float = 0.5,
                         mask=None, source: EulerSource | None = None):
    """Find the initial velocity whose cfg.steps rollout carries sigma0 to
    target_sigma, by Adam (train/loop.make_optimizer) on the gradient through
    the solver. Returns (u0_opt [3, nz, ny, nx], losses [opt_steps]); u0_opt
    passes through cfg's projection. The device follows sigma0."""
    from phys_autodiff_tpu_torch.train.loop import TrainConfig, make_optimizer

    if u0_init is None:
        u0_init = torch.zeros((3,) + g.shape, dtype=torch.float32, device=sigma0.device)
    params = {"u": u0_init.detach().clone().requires_grad_()}
    opt = make_optimizer(TrainConfig(learning_rate=learning_rate), params)
    losses = []
    for _ in range(opt_steps):
        loss = rollout_loss(g, params["u"], sigma0, target_sigma, cfg, mask=mask, source=source)
        (params["u"].grad,) = torch.autograd.grad(loss, [params["u"]])
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        u = _project(g, params["u"].detach(), cfg, mask)
    return u, torch.stack(losses)


def initial_state_from_model(g: GridSpec, model_cfg, params, t: float, *, project: bool = True) -> EulerState:
    """Seed the solver from a trained field model at time t (MLP or any
    encoder family), projecting the model's velocity first by default."""
    from phys_autodiff_tpu_torch.models.sample import grid_infer_any

    y = grid_infer_any(g, model_cfg, params, t)
    sigma = y[..., 0].contiguous()
    u = torch.movedim(y[..., 1:4], -1, 0).contiguous()
    if project:
        u = projection.project(g, u)
    return EulerState(sigma, u)


# ---------------------------------------------------------------------------
# The z-sharded rollout
# ---------------------------------------------------------------------------


def _rows_confinement(g: GridSpec, mesh, u, eps: float):
    """vorticity_confinement of a rank's rows: x and y differences local,
    the z differences against halos, ux's and uy's in one exchange (JAX's
    batched halo); the single-device arithmetic cell for cell."""
    ix, iy, iz = inv2h_f32(g.hx), inv2h_f32(g.hy), inv2h_f32(g.hz)
    per = g.periodic

    def cd(f, axis, inv2h):
        return central_diff(f, axis, inv2h, per)

    dz01 = spectral._halo_zdiff(mesh, u[:2], iz, per)  # [2, nz_local, ny, nx]: d ux / dz, d uy / dz
    w = torch.stack([cd(u[2], 1, iy) - dz01[1], dz01[0] - cd(u[2], 2, ix), cd(u[1], 2, ix) - cd(u[0], 1, iy)])
    wmag = torch.sqrt(torch.sum(w * w, dim=0) + float(np.float32(1e-30)))
    eta = spectral.local_grad(g, mesh, wmag)
    n = eta / (torch.sqrt(torch.sum(eta * eta, dim=0)) + float(np.float32(1e-20)))
    h = float((g.hx * g.hy * g.hz) ** (1.0 / 3.0))
    s = float(np.float32(eps * h))
    return s * torch.stack([
        n[1] * w[2] - n[2] * w[1],
        n[2] * w[0] - n[0] * w[2],
        n[0] * w[1] - n[1] * w[0],
    ])


class _Adjoint(torch.autograd.Function):
    """y -> A^T y for a linear operator A = fwd, by torch.autograd.grad
    through fwd at zero (across the ranks: fwd's halos are differentiable).
    Its own VJP is A: the single-device normal_solve's torch.func.vjp is
    differentiable in y the same way."""

    @staticmethod
    def forward(ctx, fwd, y):
        ctx.fwd = fwd
        with torch.enable_grad():
            p0 = torch.zeros_like(y, requires_grad=True)
            (out,) = torch.autograd.grad(fwd(p0), p0, y)
        return out

    @staticmethod
    def backward(ctx, d_out):
        return None, ctx.fwd(d_out)


def project_masked_sharded(g: GridSpec, mesh, u, mask, *, maxiter: int = 200, tol: float = 1e-6):
    """ops.obstacles.project_masked on a rank's rows u [3, nz_local, ny, nx]
    and mask [nz_local, ny, nx], either boundary: the masked operator on the
    rows against halos, A^T by torch.autograd.grad through the
    differentiable halo (its backward returns each halo plane's cotangent
    to its owner), CG's inner products and the fluid mean summed over the
    ranks in rank order. The JAX package gets the same program from the
    GSPMD partitioner; here the exchanges are written out. Differentiable
    in u, as project_masked is (CG by implicit differentiation)."""
    u_s = obstacles.apply_no_slip(u, mask)
    d = mask * spectral.local_divergence(g, mesh, u_s)
    n_fluid = torch.clamp_min(mesh.chain_sum(torch.sum(mask)), 1.0)
    d = mask * (d - mesh.chain_sum(torch.sum(d)) / n_fluid)

    def fwd(p):
        grad_p = obstacles.apply_no_slip(spectral.local_grad(g, mesh, p), mask)
        return mask * spectral.local_divergence(g, mesh, grad_p)

    def adjoint(y):
        return _Adjoint.apply(fwd, y)

    def vdot(x, y):
        return mesh.chain_sum(torch.dot(x.reshape(-1), y.reshape(-1)))

    p, _ = cg(lambda q: adjoint(fwd(q)), adjoint(d), tol=tol, maxiter=maxiter, vdot=vdot)
    return u_s - obstacles.apply_no_slip(spectral.local_grad(g, mesh, p), mask)


def rollout_sharded(g: GridSpec, state0: EulerState, cfg: EulerConfig, mesh, *, mask=None,
                    source: EulerSource | None = None):
    """The multi-rank Euler rollout: state0 holds this rank's rows (sigma
    [nz_local, ny, nx], u [3, nz_local, ny, nx]), and so do the result, mask
    and source. Each stage is written shard-locally with explicit
    collectives, in euler_step's order:

      * advection: the shard-local semi-Lagrangian or limited MacCormack
        step (apps/transport.make_shard_local_step[_many]: halo exchanges
        and K8's slab form; the self-advection one batched pass),
      * buoyancy, vorticity confinement (z differences against halos; ux's
        and uy's in one exchange), sources,
      * viscosity and diffusivity: the pencil-decomposed implicit solve
        (parallel/spectral.shard_local_diffuse_fft),
      * projection: the pencil FFT (parallel/spectral), or with a mask the
        masked CGNR on the shards (project_masked_sharded),
      * diagnostics: max_cfl and max_abs_div by an all-reduce max (over the
        interior fluid cells with a mask), the kinetic energy a sum over
        the ranks in rank order over the cell count. They are replicated
        on every rank and carry no gradient.

    Without a mask the grid must be periodic and the projection "auto" or
    "fft", as in JAX; with a mask either boundary, but viscosity and
    diffusivity only on a periodic grid (the pencil solve). Parity with
    rollout is float rounding (the pencil FFT's order; the sharded CG's
    sums). The final state is differentiable in state0 (and the source)
    across the ranks: every rank runs the backward of its part of the loss,
    and the loss is the sum of the parts. cfg.remat checkpoints each step
    when a gradient is asked for, which changes no forward bit. Returns
    (this rank's final EulerState, diagnostics as in rollout)."""
    _, nzl = mesh.rows(g.nz)  # every check before the first collective, on every rank alike
    rows = (nzl, g.ny, g.nx)
    if tuple(state0.sigma.shape) != rows or tuple(state0.u.shape) != (3,) + rows:
        raise ValueError(f"expected this rank's rows {rows}, got {tuple(state0.sigma.shape)} and "
                         f"{tuple(state0.u.shape)}")
    if mask is None:
        if not g.periodic:
            raise ValueError("rollout_sharded without a mask requires periodic boundaries (the FFT projection)")
        if cfg.projection not in ("auto", "fft"):
            raise ValueError(f"rollout_sharded without a mask projects by FFT, not {cfg.projection!r}")
    elif tuple(mask.shape) != rows:
        raise ValueError(f"mask: expected this rank's rows {rows}, got {tuple(mask.shape)}")
    if (cfg.viscosity != 0.0 or cfg.diffusivity != 0.0) and not g.periodic:
        raise ValueError("the sharded diffusion is the periodic pencil solve")

    tcfg = TransportConfig(scheme=cfg.advection)
    tstep = make_shard_local_step(g, tcfg, mesh)
    tstep_many = make_shard_local_step_many(g, tcfg, mesh)
    if mask is None:
        project = spectral.shard_local_project_fft(g, mesh)
    elif cfg.projection == "none":
        project = lambda u: u  # noqa: E731
    else:
        project = lambda u: project_masked_sharded(g, mesh, u, mask, maxiter=cfg.cg_maxiter,  # noqa: E731
                                                   tol=cfg.cg_tol)
    diffuse_u = spectral.shard_local_diffuse_fft(g, mesh, cfg.viscosity, cfg.dt) if cfg.viscosity != 0.0 else None
    diffuse_s = spectral.shard_local_diffuse_fft(g, mesh, cfg.diffusivity, cfg.dt) if cfg.diffusivity != 0.0 else None
    dt = float(np.float32(cfg.dt))
    no_slip = (lambda f: f) if mask is None else (lambda f: obstacles.apply_no_slip(f, mask))
    if mask is None:
        interior = None
    else:  # ops.obstacles.fluid_divergence's eroded mask: the z neighbours from the halo
        m_ext = halo_extend_z_diff(mesh, mask, g.periodic, 0)
        interior = mask * m_ext[:-2] * m_ext[2:]
        for axis in (1, 2):
            interior = interior * shift(mask, -1, axis, g.periodic) * shift(mask, +1, axis, g.periodic)

    def step_fn(sigma, u):
        u, sigma = no_slip(u), no_slip(sigma)
        u_adv = no_slip(tstep_many(u, u, cfg.dt))
        if cfg.buoyancy != 0.0:
            fz = float(np.float32(cfg.buoyancy)) * sigma
            if mask is not None:
                fz = fz * mask
            u_adv = torch.cat([u_adv[:2], (u_adv[2] + dt * fz)[None]])
        if cfg.confinement != 0.0:
            u_adv = u_adv + dt * no_slip(_rows_confinement(g, mesh, u_adv, cfg.confinement))
        if source is not None:
            f = source.force if mask is None else source.force * mask[None]
            u_adv = u_adv + dt * f
        if diffuse_u is not None:
            u_adv = no_slip(diffuse_u(u_adv))
        u_new = project(u_adv)
        sigma_new = tstep(sigma, u_new, cfg.dt)
        if source is not None:
            rate = source.sigma_rate if mask is None else source.sigma_rate * mask
            sigma_new = sigma_new + dt * rate
        if diffuse_s is not None:
            sigma_new = diffuse_s(sigma_new)
        if mask is not None:
            sigma_new = sigma_new * mask
        return sigma_new, u_new

    n_cells = float(g.num_cells)
    state = tuple(state0)
    cfls, divs, kes = [], [], []
    for _ in range(cfg.steps):
        if cfg.remat and torch.is_grad_enabled():
            state = checkpoint(step_fn, *state, use_reentrant=False)
        else:
            state = step_fn(*state)
        with torch.no_grad():
            u = state[1]
            div = torch.abs(spectral.local_divergence(g, mesh, u))
            if interior is not None:
                div = interior * div
            maxes = mesh.all_reduce(torch.stack([max_cfl(g, u, cfg.dt), torch.max(div)]), op=dist.ReduceOp.MAX)
            cfls.append(maxes[0])
            divs.append(maxes[1])
            kes.append(0.5 * mesh.chain_sum(torch.sum(torch.sum(u * u, dim=0))) / n_cells)
    diag = {"max_cfl": torch.stack(cfls), "max_abs_div": torch.stack(divs), "kinetic_energy": torch.stack(kes)}
    return EulerState(*state), diag
