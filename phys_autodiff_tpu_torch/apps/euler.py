"""Incompressible Euler "smoke" solver: advect / force / project (port of the
single-device half of phys_autodiff_tpu/apps/euler.py).

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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from phys_autodiff_tpu_torch.apps.transport import TransportConfig, make_step, make_step_many, max_cfl
from phys_autodiff_tpu_torch.ops import diagnostics, diffusion, obstacles, projection
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
