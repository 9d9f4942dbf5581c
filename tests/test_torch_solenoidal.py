"""Divergence-free field heads, u = curl A (phys_autodiff_tpu_torch/models/
solenoidal.py), against the JAX package's models/solenoidal.py: the
counterpart of tests/test_solenoidal.py.

Both packages start from bitwise-equal seeded params. Limits: grid fields
1e-5 relative to the field's max (and the discrete divergence zero to 1e-5 of
it, both boundary modes, MLP and hash-encoded heads); the training
trajectory 1e-4 relative a step; the point curl 1e-5, and its continuous
divergence zero to 5e-5 of the Jacobian's scale (test_solenoidal.py:112).
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.models import solenoidal as jsol
from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.models import mlp, ngp, solenoidal
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.ops.diagnostics import divergence
from phys_autodiff_tpu_torch.train import TrainConfig
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jngp, jloop)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(periodic=True, nx=12, ny=10, nz=8):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.4, dt=1e-2, periodic=periodic)


MCFG = MLPGridConfig(dims=MLPDims(H=32))
NCFG = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, features_per_level=2, log2_table_size=6,
                                                      base_resolution=4, max_resolution=8), hidden=16)


def _rel_close(port, ref, limit):
    port, ref = port.detach().numpy(), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(port - ref).max()) <= limit * scale, float(np.abs(port - ref).max()) / scale


def _params(family, seed):
    if family == "mlp":
        return MCFG, mlp.init_params(MCFG.dims, seed=seed, scale=0.5, device="cpu"), jmlp.init_params(
            _jax(MCFG.dims), seed=seed, scale=0.5)
    # tables scaled to O(1) features (the init's 1e-4 scale would leave u at
    # the rounding floor of the curl's differences)
    params = ngp.init_ngp_params(NCFG, seed=seed, device="cpu")
    params["tables"] = tree.map_tree(lambda a: a * 2000.0, params["tables"])
    jparams = dict(jngp.init_ngp_params(_jax(NCFG), seed=seed))
    jparams["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jparams["tables"])
    return NCFG, params, jparams


@pytest.mark.parametrize("family", ["mlp", "hash"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_grid_fields_match_jax_and_are_divergence_free(family, periodic):
    g = _grid(periodic)
    cfg, params, jparams = _params(family, 5)
    sigma, u = solenoidal.grid_infer_solenoidal(g, cfg, params, 0.3)
    jsigma, ju = jsol.grid_infer_solenoidal(_jax(g), _jax(cfg), jparams, 0.3)
    _rel_close(sigma, jsigma, 1e-5)
    _rel_close(u, ju, 1e-5)
    assert float(divergence(g, u).abs().max()) <= 1e-5 * float(u.abs().max())
    fs = solenoidal.generate_fields_solenoidal(g, cfg, params, 0.25, g.dt)
    jfs = jsol.generate_fields_solenoidal(_jax(g), _jax(cfg), jparams, 0.25, g.dt)
    for a, b in zip(fs, jfs):
        _rel_close(a, b, 1e-5)
    for v in (fs.u_tm1, fs.u_t, fs.u_tp1):
        assert float(divergence(g, v).abs().max()) <= 1e-5 * float(v.abs().max())


def test_training_trajectory_matches_jax():
    g = GridSpec(nx=12, ny=8, nz=6, hx=0.4, hy=0.4, hz=0.8, dt=1e-2)
    cfg = TrainConfig(steps=0, learning_rate=3e-3, t=0.25, seed=1)
    params0 = mlp.init_params(MCFG.dims, seed=1, device="cpu")
    step, state = solenoidal.make_solenoidal_train_step(g, PhysWeights(), MCFG, cfg, params0)
    jstep, jstate = jsol.make_solenoidal_train_step(_jax(g), _jax(PhysWeights()), _jax(MCFG), _jax(cfg),
                                                    jmlp.init_params(_jax(MCFG.dims), seed=1))
    losses, jlosses = [], []
    for _ in range(5):
        state, loss = step(state)
        jstate, jloss = jstep(jstate)
        losses.append(float(loss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    _, u = solenoidal.grid_infer_solenoidal(g, MCFG, state.params, 0.25)
    assert float(divergence(g, u).abs().max()) <= 1e-5 * float(u.abs().max())


def test_point_curl_matches_jax_and_is_divergence_free():
    g = _grid()
    params = mlp.init_params(MCFG.dims, seed=8, scale=0.5, device="cpu")
    jparams = jmlp.init_params(_jax(MCFG.dims), seed=8, scale=0.5)
    pts = np.random.default_rng(0).uniform(0.1, 0.9, size=(8, 3)).astype(np.float32)
    sigma, u = solenoidal.eval_points_solenoidal(g, MCFG, params, torch.tensor(pts), 0.3)
    jsigma, ju = jsol.eval_points_solenoidal(_jax(g), _jax(MCFG), jparams, jnp.asarray(pts), 0.3)
    _rel_close(sigma, jsigma, 1e-5)
    _rel_close(u, ju, 1e-5)
    inv_h = np.array([1.0 / ((g.nx - 1) * g.hx), 1.0 / ((g.ny - 1) * g.hy), 1.0 / ((g.nz - 1) * g.hz)], np.float32)

    def u_at(p):  # [3] -> [3]
        return solenoidal.eval_points_solenoidal(g, MCFG, params, p[None, :], 0.3)[1][0]

    for p in pts:
        J = torch.func.jacfwd(u_at)(torch.tensor(p))  # J[c, a] = du_c / dunit_a
        div = float(J[0, 0] * inv_h[0] + J[1, 1] * inv_h[1] + J[2, 2] * inv_h[2])
        assert abs(div) <= 5e-5 * float(J.abs().max()) * float(inv_h.max()) + 1e-30
    # the params' gradient flows through the point curl
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = torch.autograd.grad(solenoidal.eval_points_solenoidal(g, MCFG, p, torch.tensor(pts), 0.3)[1].sum(),
                                [p["W1"], p["W2"]])
    assert all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0 for x in grads)
