"""Tracer-particle advection (phys_autodiff_tpu_torch/apps/advect.py) against
the JAX package's apps/advect.py: the advect half of
tests/test_sample_advect.py.

The same seeded params (the port's init_params is bitwise the JAX package's)
and the same numpy particles go through both packages: explicit Euler and RK2,
velocity from a model and from a grid snapshot, periodic wrap and clamp, and
the recorded trajectory. Limit: 1e-5 absolute in index coordinates (a few
float32 ulps of positions up to 16).
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.apps import advect as jadv
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.apps import advect as adv
from phys_autodiff_tpu_torch.models import mlp, sample

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jadv)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(periodic=True):
    return GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.25, hz=0.125, dt=1e-3, periodic=periodic)


CFG = MLPGridConfig(dims=MLPDims(H=16))


def _particles(g, n=16, seed=4):
    return np.random.default_rng(seed).uniform(0, [g.nx, g.ny, g.nz], size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("method", ["euler", "rk2"])
def test_model_velocity_matches_jax(periodic, method):
    g = _grid(periodic)
    params = mlp.init_params(CFG.dims, seed=11, scale=0.8, device="cpu")
    jparams = jmlp.init_params(_jax(CFG.dims), seed=11, scale=0.8)
    acfg = adv.AdvectConfig(steps=15, dt=2e-2, method=method)
    pts = _particles(g)
    out = adv.advect(g, adv.velocity_fn_from_model(g, CFG, params), torch.tensor(pts), 0.1, acfg)
    ref = jadv.advect(_jax(g), jadv.velocity_fn_from_model(_jax(g), _jax(CFG), jparams), jnp.asarray(pts), 0.1,
                      _jax(acfg))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    hi = np.array([g.nx, g.ny, g.nz], np.float32) - (0.0 if periodic else 1.0)
    assert np.all(out.detach().numpy() >= 0) and np.all(out.detach().numpy() <= hi)
    # make_advect_fn: the same rollout for repeated initial positions
    again = adv.make_advect_fn(g, adv.velocity_fn_from_model(g, CFG, params), 0.1, acfg)(torch.tensor(pts))
    np.testing.assert_array_equal(again.detach().numpy(), out.detach().numpy())


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_grid_velocity_and_trajectory_match_jax(periodic):
    g = _grid(periodic)
    rng = np.random.default_rng(2)
    u_grid = (rng.normal(size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None] * 20).astype(
        np.float32)
    acfg = adv.AdvectConfig(steps=12, dt=1e-2, method="rk2", record_every=3)
    pts = _particles(g, 9, 5)
    final, frames = adv.advect(g, adv.velocity_fn_from_grid(g, torch.tensor(u_grid)), torch.tensor(pts), 0.0, acfg)
    jfinal, jframes = jadv.advect(_jax(g), jadv.velocity_fn_from_grid(_jax(g), jnp.asarray(u_grid)),
                                  jnp.asarray(pts), 0.0, _jax(acfg))
    assert frames.shape == (4, 9, 3)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=0, atol=1e-5)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(frames[-1].numpy(), final.numpy())


def test_periodic_wrap_and_seam_band():
    """A constant velocity wraps particles with period n; a query in the seam
    band (n-1, n) evaluates the model at the u = 1 face."""
    g = _grid(True)
    u = (1.0, -2.0, 0.5)
    vel = lambda p, t: torch.tensor(u, dtype=torch.float32).expand(p.shape)  # noqa: E731
    acfg = adv.AdvectConfig(steps=40, dt=2e-2, method="euler")
    pts0 = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    final = adv.advect(g, vel, torch.tensor(pts0), 0.0, acfg)
    drift = np.asarray([u[0] / g.hx, u[1] / g.hy, u[2] / g.hz]) * acfg.steps * acfg.dt
    np.testing.assert_allclose(final.numpy(), (pts0 + drift) % np.array([g.nx, g.ny, g.nz]), atol=1e-4)
    params = mlp.init_params(CFG.dims, seed=21, scale=0.4, device="cpu")
    band = torch.tensor([[g.nx - 0.5, 1.0, 1.0]])
    face = torch.tensor([[1.0, 1.0 / (g.ny - 1), 1.0 / (g.nz - 1)]])
    np.testing.assert_array_equal(adv.velocity_fn_from_model(g, CFG, params)(band, 0.2).detach().numpy(),
                                  sample.evaluate_points(CFG, params, face, 0.2)[..., 1:4].detach().numpy())
    with pytest.raises(ValueError, match="unknown method"):
        adv.advect(g, vel, torch.tensor(pts0), 0.0, adv.AdvectConfig(method="rk4"))
