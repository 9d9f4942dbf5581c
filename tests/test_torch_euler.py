"""The incompressible-Euler smoke solver (phys_autodiff_tpu_torch/apps/euler.py)
against the JAX package's apps/euler.py.

The same numpy states go through both packages; the port's K8 runs its plain
version on the CPU. Limits: periodic (FFT projection) 1e-5 relative to the
field's max; clamp (CGNR, 20 iterations; see tests/test_torch_fluid_ops.py
for why not more) with an obstacle and a source 1e-4; the rollout loss's
gradient at tests/test_euler.py:395's 2e-5 / 1e-7.
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.apps import euler as jeu
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.ops import obstacles as jobs
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.apps import euler
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.ops import obstacles

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jeu)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(periodic=True, nx=16, ny=12, nz=8):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=periodic)


def _smooth_u(g, seed=0, scale=1.0):
    """tests/test_euler.py's _smooth_u: a product of low sines per component."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    comps = []
    for _ in range(3):
        kx, ky, kz = rng.integers(1, 3, size=3)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        comps.append((np.sin(2 * np.pi * kx * x / g.nx + ph[0]) * np.sin(2 * np.pi * ky * y / g.ny + ph[1])
                      * np.sin(2 * np.pi * kz * z / g.nz + ph[2])).astype(np.float32))
    return (np.stack(comps) * scale).astype(np.float32)


def _sigma(g, seed=0):
    return np.abs(np.random.default_rng(seed).normal(size=g.shape)).astype(np.float32)


def _rel_close(port, ref, limit):
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(port - ref).max()) <= limit * scale, float(np.abs(port - ref).max()) / scale


def _obstacle_and_source(g):
    """A solid box, an emitter straddling it and an x fan (both packages)."""
    m = obstacles.box_mask(g, (2, 3, 4), (5, 7, 9), device="cpu")
    jm = jobs.box_mask(_jax(g), (2, 3, 4), (5, 7, 9))
    rate = np.zeros(g.shape, np.float32)
    rate[1:6, 2:8, 3:10] = 2.0
    force = np.zeros((3,) + g.shape, np.float32)
    force[0, 1:6, 2:8, 9:14] = 3.0
    src = euler.EulerSource(torch.tensor(rate), torch.tensor(force))
    jsrc = jeu.EulerSource(jnp.asarray(rate), jnp.asarray(force))
    return m, jm, src, jsrc


def test_stages_match_jax():
    g = _grid()
    jg = _jax(g)
    u = _smooth_u(g, 3, 0.5)
    for eps in (1.0, 3.0):
        _rel_close(euler.vorticity_confinement(g, torch.tensor(u), eps), jeu.vorticity_confinement(jg, u, eps), 1e-5)
    const = np.broadcast_to(np.array([0.7, -0.3, 0.2], np.float32)[:, None, None, None], (3,) + g.shape).copy()
    assert float(euler.vorticity_confinement(g, torch.tensor(const), 5.0).abs().max()) <= 1e-7
    for periodic, mode, limit in ((True, "fft", 1e-5), (True, "none", 0.0), (False, "cg", 1e-4), (False, "auto", 1e-4)):
        gg = _grid(periodic)
        cfg = euler.EulerConfig(projection=mode, cg_maxiter=20)
        _rel_close(euler._project(gg, torch.tensor(u), cfg), jeu._project(_jax(gg), u, _jax(cfg)), limit)
    m, jm, _, _ = _obstacle_and_source(g)
    cfg = euler.EulerConfig(cg_maxiter=20)
    _rel_close(euler._project(g, torch.tensor(u), cfg, m), jeu._project(jg, u, _jax(cfg), jm), 1e-4)
    for scheme in ("semi_lagrangian", "maccormack"):
        cfg = euler.EulerConfig(dt=0.05, advection=scheme)
        _rel_close(euler._advect_many(g, cfg)(torch.tensor(u), torch.tensor(u), cfg.dt),
                   jeu._advect_many(jg, _jax(cfg))(u, u, cfg.dt), 1e-6)
    with pytest.raises(ValueError, match="unknown projection"):
        euler._project(g, torch.tensor(u), euler.EulerConfig(projection="spectral"))


@pytest.mark.parametrize("scheme", ["semi_lagrangian", "maccormack"])
def test_periodic_rollout_matches_jax(scheme):
    """4 FFT-projected steps with buoyancy, confinement, viscosity and
    diffusivity, and the per-step diagnostics."""
    g = _grid()
    cfg = euler.EulerConfig(dt=0.05, steps=4, buoyancy=0.5, confinement=1.5, viscosity=0.05, diffusivity=0.02,
                            advection=scheme)
    sigma, u = _sigma(g, 1), _smooth_u(g, 2, 0.4)
    st, diag = euler.rollout(g, euler.EulerState(torch.tensor(sigma), torch.tensor(u)), cfg)
    jst, jdiag = jeu.rollout(_jax(g), jeu.EulerState(jnp.asarray(sigma), jnp.asarray(u)), _jax(cfg))
    _rel_close(st.sigma, jst.sigma, 1e-5)
    _rel_close(st.u, jst.u, 1e-5)
    for k in ("max_cfl", "kinetic_energy"):
        np.testing.assert_allclose(diag[k].numpy(), np.asarray(jdiag[k]), rtol=1e-5)
    assert diag["max_abs_div"].shape == (4,) and float(diag["max_abs_div"].max()) <= 1e-5 * float(st.u.abs().max())
    np.testing.assert_allclose(diag["max_abs_div"].numpy(), np.asarray(jdiag["max_abs_div"]), rtol=0,
                               atol=1e-5 * float(st.u.abs().max()))


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_rollout_with_an_obstacle_and_sources_matches_jax(periodic):
    """CGNR (masked) projection, a solid box, an emitter and a fan."""
    g = _grid(periodic)
    m, jm, src, jsrc = _obstacle_and_source(g)
    cfg = euler.EulerConfig(dt=0.05, steps=4, buoyancy=0.5, cg_maxiter=20, viscosity=0.0 if periodic else 0.05,
                            advection="maccormack")
    sigma, u = _sigma(g, 4), _smooth_u(g, 5, 0.3)
    st, diag = euler.rollout(g, euler.EulerState(torch.tensor(sigma), torch.tensor(u)), cfg, mask=m, source=src)
    jst, jdiag = jeu.rollout(_jax(g), jeu.EulerState(jnp.asarray(sigma), jnp.asarray(u)), _jax(cfg), mask=jm,
                             source=jsrc)
    _rel_close(st.sigma, jst.sigma, 1e-4)
    _rel_close(st.u, jst.u, 1e-4)
    np.testing.assert_allclose(diag["max_abs_div"].numpy(), np.asarray(jdiag["max_abs_div"]), rtol=1e-3)
    solid = (m == 0).numpy()
    assert np.all(st.sigma.numpy()[solid] == 0.0) and np.all(st.u.numpy()[:, solid] == 0.0)


def test_clamp_cg_step_matches_jax():
    g = _grid(False)
    cfg = euler.EulerConfig(dt=0.05, steps=1, buoyancy=0.3, cg_maxiter=20)
    sigma, u = _sigma(g, 6), _smooth_u(g, 7, 0.4)
    st = euler.euler_step(g, euler.EulerState(torch.tensor(sigma), torch.tensor(u)), cfg)
    jst = jeu.euler_step(_jax(g), jeu.EulerState(jnp.asarray(sigma), jnp.asarray(u)), _jax(cfg))
    _rel_close(st.sigma, jst.sigma, 1e-4)
    _rel_close(st.u, jst.u, 1e-4)


@pytest.fixture(scope="module")
def loss_case():
    g = _grid(nx=12, ny=8, nz=6)
    kw = dict(dt=1e-2, steps=3, buoyancy=0.5, confinement=1.0, advection="maccormack")
    sigma0, u0 = _sigma(g, 8), _smooth_u(g, 3)
    target = _sigma(g, 9)
    jgrad = jax.jit(jax.grad(lambda u: jeu.rollout_loss(_jax(g), u, sigma0, target, jeu.EulerConfig(**kw))))(u0)
    return g, kw, sigma0, u0, target, np.asarray(jgrad)


@pytest.mark.parametrize("remat", [False, True])
def test_rollout_loss_gradient_matches_jax_grad(loss_case, remat):
    """The gradient through MacCormack, the limiter, confinement and the FFT
    projection (remat=True: torch.utils.checkpoint, same values)."""
    g, kw, sigma0, u0, target, jgrad = loss_case
    cfg = euler.EulerConfig(remat=remat, **kw)
    ut = torch.tensor(u0).requires_grad_()
    loss = euler.rollout_loss(g, ut, torch.tensor(sigma0), torch.tensor(target), cfg)
    (grad,) = torch.autograd.grad(loss, [ut])
    assert bool(torch.isfinite(grad).all())
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=2e-5, atol=1e-7)


def test_fit_initial_velocity_tracks_jax():
    """3 Adam steps through the solver (torch.optim.Adam vs optax.adam)."""
    g = _grid(nx=12, ny=8, nz=6)
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    blob = lambda cx: np.exp(-(((x - cx) / 2.0) ** 2 + ((y - 4) / 2.0) ** 2 + ((z - 3) / 2.0) ** 2)).astype(
        np.float32)  # noqa: E731
    cfg = euler.EulerConfig(dt=0.05, steps=3, projection="fft")
    u_opt, losses = euler.fit_initial_velocity(g, torch.tensor(blob(4)), torch.tensor(blob(6)), cfg, opt_steps=3,
                                               learning_rate=0.5)
    ju, jlosses = jeu.fit_initial_velocity(_jax(g), jnp.asarray(blob(4)), jnp.asarray(blob(6)), _jax(cfg),
                                           opt_steps=3, learning_rate=0.5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    assert float(losses[-1]) < float(losses[0])
    _rel_close(u_opt, ju, 1e-4)


def test_initial_state_from_model_matches_jax():
    g = _grid()
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=13, scale=0.2, device="cpu")
    jparams = jmlp.init_params(_jax(cfg.dims), seed=13, scale=0.2)
    for project in (True, False):
        st = euler.initial_state_from_model(g, cfg, params, 0.25, project=project)
        jst = jeu.initial_state_from_model(_jax(g), _jax(cfg), jparams, 0.25, project=project)
        _rel_close(st.sigma, jst.sigma, 1e-6)
        _rel_close(st.u, jst.u, 1e-5)
    zeros = euler.EulerSource.zeros(g, device="cpu")
    assert zeros.sigma_rate.shape == g.shape and zeros.force.shape == (3,) + g.shape
