"""The port's serving surface (phys_autodiff_tpu_torch/models/sample.py) vs the
JAX package's models/sample.py, and its own oracles.

Inputs are made with numpy from a seed and handed to both packages. Point
evaluation at grid nodes is held to grid inference bit for bit (MLP) or at
2e-5 (the NGP's pointwise encoder against the grid resampling, as in
tests/test_sample_advect.py:138-151); the port against the JAX package at
MLP_INFER_REL (1e-6 relative L2, float32 matmuls in another order) and the
bf16 point tier at BF16_REL (1e-3 of the output's scale); the trilinear
sampler against JAX at 1e-6 absolute and against its analytic oracles.
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.models import sample as jsample
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.models import mlp, ngp, sample
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jfourier, jngp)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes and enums)."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(periodic=True, nx=8, ny=6, nz=5):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.125, dt=1e-3, periodic=periodic)


def _node_points(g):
    """Every grid node as unit coords [N, 3] (x, y, z), z slowest."""
    iz, iy, ix = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    return np.stack([ix.ravel() / max(g.nx - 1, 1), iy.ravel() / max(g.ny - 1, 1), iz.ravel() / max(g.nz - 1, 1)],
                    axis=-1).astype(np.float32)


SMALL_HASH = HashEncodingConfig(num_levels=3, log2_table_size=7, base_resolution=3, max_resolution=12,
                                dense_oversubscribed=True)


def _mlp(norm=CoordNorm.MinusOneToOne, seed=123):
    cfg = MLPGridConfig(dims=MLPDims(H=16), norm=norm)
    return cfg, mlp.init_params(cfg.dims, seed=seed, device="cpu")


def _ngp(encoding=SMALL_HASH, seed=7):
    cfg = ngp.NGPFieldConfig(encoding=encoding, hidden=16)
    jp = jngp.init_ngp_params(_jax(cfg), seed=seed)
    return cfg, jp, ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _jax_params(params):
    return {k: jnp.asarray(v.numpy()) for k, v in params.items()}


# ---------------------------------------------------------------- coordinates


@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne])
def test_point_coords_and_index_maps_match_jax(norm):
    g = _grid(nx=9, ny=1, nz=4)
    pts = np.random.default_rng(0).uniform(0, 1, (33, 3)).astype(np.float32)
    np.testing.assert_array_equal(sample.point_coords(torch.tensor(pts), 0.3, norm).numpy(),
                                  np.asarray(jsample.point_coords(jnp.asarray(pts), 0.3, _jax(norm))))
    idx = sample.unit_to_index(g, torch.tensor(pts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jsample.unit_to_index(_jax(g), jnp.asarray(pts))))
    np.testing.assert_array_equal(sample.index_to_unit(g, idx).numpy(),
                                  np.asarray(jsample.index_to_unit(_jax(g), jnp.asarray(idx.numpy()))))
    if norm == CoordNorm.ZeroToOne:  # the reference's t + 0.5 quirk
        assert float(sample.point_coords(torch.tensor(pts), 0.3, norm)[0, 3]) == float(np.float32(0.3) + 0.5)


# ------------------------------------------------------- point model serving


@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne])
def test_mlp_points_match_grid_infer_at_nodes_and_jax(norm):
    g = _grid(periodic=False, nx=6, ny=5, nz=4)
    cfg, params = _mlp(norm)
    pts = _node_points(g)
    y_grid = sample.grid_infer_any(g, cfg, params, 0.3)
    y_pts = sample.mlp_eval_points(cfg, params, torch.tensor(pts), 0.3)
    torch.testing.assert_close(y_pts, y_grid.reshape(-1, 4), rtol=0, atol=0)
    y_jax = jsample.mlp_eval_points(_jax(cfg), _jax_params(params), jnp.asarray(pts), 0.3)
    assert rel_l2_err(y_pts.numpy(), np.asarray(y_jax)) <= tol.MLP_INFER_REL
    g_jax = jsample.grid_infer_any(_jax(g), _jax(cfg), _jax_params(params), 0.3)
    assert rel_l2_err(y_grid.numpy(), np.asarray(g_jax)) <= tol.MLP_INFER_REL


@pytest.mark.parametrize("encoding", [SMALL_HASH, FourierEncodingConfig(num_frequencies=2)], ids=["hash", "fourier"])
def test_ngp_points_match_grid_infer_at_nodes_and_jax(encoding):
    g = _grid(periodic=True, nx=6, ny=5, nz=4)
    cfg, jp, params = _ngp(encoding)
    pts = _node_points(g)
    y_grid = sample.grid_infer_any(g, cfg, params, 0.25)
    y_pts = sample.evaluate_points(cfg, params, torch.tensor(pts), 0.25)
    np.testing.assert_allclose(y_pts.numpy(), y_grid.reshape(-1, 4).numpy(), rtol=2e-5, atol=2e-5)
    y_jax = jsample.evaluate_points(_jax(cfg), jp, jnp.asarray(pts), 0.25)
    assert rel_l2_err(y_pts.numpy(), np.asarray(y_jax)) <= tol.MLP_INFER_REL
    assert rel_l2_err(y_grid.numpy(), np.asarray(jsample.grid_infer_any(_jax(g), _jax(cfg), jp, 0.25))) <= \
        tol.MLP_INFER_REL


@pytest.mark.parametrize("family", ["mlp", "ngp"])
def test_batched_points_equal_unbatched(family):
    if family == "mlp":
        cfg, params = _mlp()
    else:
        cfg, _, params = _ngp()
    pts = torch.tensor(np.random.default_rng(4).uniform(0, 1, (1000, 3)).astype(np.float32))
    whole = sample.evaluate_points(cfg, params, pts, 0.4)
    torch.testing.assert_close(sample.evaluate_points_batched(cfg, params, pts, 0.4, batch_size=96), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(sample.evaluate_points_batched(cfg, params, pts, 0.4), whole, rtol=0, atol=0)


def test_mlp_bf16_tier_matches_jax_and_tracks_f32():
    cfg = MLPGridConfig()
    params = mlp.init_params(cfg.dims, seed=17, scale=0.4, device="cpu")
    pts = np.random.default_rng(8).uniform(0, 1, size=(256, 3)).astype(np.float32)
    b16 = sample.mlp_eval_points(cfg, params, torch.tensor(pts), 0.3, precision="bf16").numpy()
    f32 = sample.mlp_eval_points(cfg, params, torch.tensor(pts), 0.3).numpy()
    b16_jax = np.asarray(jsample.mlp_eval_points(_jax(cfg), _jax_params(params), jnp.asarray(pts), 0.3,
                                                 precision="bf16"))
    scale = float(np.max(np.abs(f32)))
    assert float(np.max(np.abs(b16 - b16_jax))) / scale <= tol.BF16_REL
    err = float(np.max(np.abs(b16 - f32))) / scale
    assert 0.0 < err <= 2e-2  # the reduced-precision path, 1e-3..1e-2 class
    ncfg, _, nparams = _ngp()
    with pytest.raises(ValueError, match="bf16 point serving"):
        sample.evaluate_points(ncfg, nparams, torch.tensor(pts), 0.3, precision="bf16")


def test_point_eval_is_differentiable_in_points_and_t():
    cfg, params = _mlp()
    pts = torch.tensor([[0.3, 0.4, 0.5]], requires_grad=True)
    t = torch.tensor(0.2, requires_grad=True)
    y = sample.evaluate_points(cfg, params, pts, t)
    gp, gt = torch.autograd.grad(y[0, 0], (pts, t))
    jp = _jax_params(params)
    jg = jax.grad(lambda p, tt: jsample.evaluate_points(_jax(cfg), jp, p, tt)[0, 0], argnums=(0, 1))(
        jnp.asarray([[0.3, 0.4, 0.5]], jnp.float32), jnp.float32(0.2))
    np.testing.assert_allclose(gp.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(gt), float(jg[1]), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- trilinear


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_trilinear_matches_jax_and_is_exact_at_nodes(periodic):
    g = _grid(periodic)
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(3,) + g.shape).astype(np.float32)
    nodes = sample.unit_to_index(g, torch.tensor(_node_points(g)))
    out = sample.trilinear_sample(torch.tensor(vals), nodes, g)
    np.testing.assert_allclose(out.numpy(), np.moveaxis(vals.reshape(3, -1), 0, -1), rtol=0, atol=1e-6)
    # queries inside, outside and on the seam; scalar and vector values
    q = rng.uniform(-3.0, 12.0, (200, 3)).astype(np.float32)
    q[:3] = [[g.nx, 0.0, 0.0], [-1.0, 0.0, 0.0], [g.nx - 0.5, g.ny, g.nz]]
    for v in (vals, vals[0]):
        port = sample.trilinear_sample(torch.tensor(v), torch.tensor(q), g).numpy()
        ref = np.asarray(jsample.trilinear_sample(jnp.asarray(v), jnp.asarray(q), _jax(g)))
        assert port.shape == ref.shape
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_trilinear_periodic_wrap_and_clamp_box():
    g = _grid(periodic=True)
    vals = torch.tensor(np.random.default_rng(2).normal(size=g.shape).astype(np.float32))
    wrap = torch.tensor([[g.nx, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, g.ny, g.nz]])
    same = torch.tensor([[0.0, 0.0, 0.0], [g.nx - 1, 0.0, 0.0], [0.0, 0.0, 0.0]])
    torch.testing.assert_close(sample.trilinear_sample(vals, wrap, g), sample.trilinear_sample(vals, same, g),
                               rtol=0, atol=1e-6)
    mid = sample.trilinear_sample(vals, torch.tensor([[g.nx - 0.5, 0.0, 0.0]]), g)
    np.testing.assert_allclose(float(mid[0]), float(0.5 * (vals[0, 0, g.nx - 1] + vals[0, 0, 0])), rtol=1e-6)
    gc = _grid(periodic=False)
    out = sample.trilinear_sample(vals, torch.tensor([[-3.0, 100.0, 2.0]]), gc)
    np.testing.assert_allclose(float(out[0]), float(vals[2, g.ny - 1, 0]), rtol=1e-6)


def test_axis_corners_on_degenerate_axes():
    f = torch.tensor([0.0, 0.7, -2.0])
    for periodic in (True, False):
        i0, i1, w = sample._axis_corners(f, 1, periodic)
        assert not i0.any() and not i1.any() and not w.any()
