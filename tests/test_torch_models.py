"""The port's model layer (phys_autodiff_tpu_torch/models) vs the JAX one.

init_params draws the same numpy MT19937 stream, so weights are bitwise
equal; coordinates are the same float32 ops, so they are bitwise equal too;
MLP outputs go through a different matmul and are held to MLP_INFER_REL.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import coords as jcoords
from phys_autodiff_tpu.models import fields as jfields
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.models import coords as tcoords
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

NORMS = [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne]


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    fields = {f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return getattr(jconfig, type(x).__name__)(**fields)


@pytest.mark.parametrize("seed, h, scale", [(42, 64, 0.5), (777, 128, 0.5), (123, 16, 0.25)])
def test_init_params_is_bitwise_the_jax_draw(seed, h, scale):
    dims = MLPDims(H=h)
    jp = jmlp.init_params(_jax(dims), seed=seed, scale=scale)
    tp = tmlp.init_params(dims, seed=seed, scale=scale, device="cpu")
    for k in ("W1", "b1", "W2", "b2"):
        assert tp[k].dtype == torch.float32 and tp[k].is_contiguous()
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_params_from_jax_and_reference_layouts():
    jp = jmlp.init_params(_jax(MLPDims(H=8)), seed=5)
    tp = tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    ref_j = jmlp.to_reference_layout(jp)
    ref_t = tmlp.to_reference_layout(tp)
    for k in ref_j:
        np.testing.assert_array_equal(ref_t[k], ref_j[k])
    back = tmlp.from_reference_layout(ref_t, device="cpu")
    for k in jp:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n.name)
@pytest.mark.parametrize("dims", [(16, 8, 4), (5, 1, 3), (1, 1, 1)], ids=["grid", "ny1", "point"])
def test_grid_coords_are_bitwise_the_jax_coords(norm, dims):
    nx, ny, nz = dims
    g = GridSpec(nx=nx, ny=ny, nz=nz)
    for n in dims:
        np.testing.assert_array_equal(
            tcoords._axis_coord(n, norm).numpy(), np.asarray(jcoords._axis_coord(n, _jax(norm)))
        )
    c_t = tcoords.grid_coords(g, 0.3, norm, device="cpu")
    c_j = jcoords.grid_coords(_jax(g), 0.3, _jax(norm))
    assert tuple(c_t.shape) == g.shape + (4,)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def _params(h=32, seed=11):
    jp = jmlp.init_params(_jax(MLPDims(H=h)), seed=seed)
    return jp, tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def test_forward_and_module_match_jax():
    jp, tp = _params()
    x = np.random.default_rng(0).uniform(-1, 1, (7, 5, 4)).astype(np.float32)
    y_j = np.asarray(jmlp.forward(jp, jnp.asarray(x)))
    y_t = tmlp.forward(tp, torch.tensor(x))
    assert tuple(y_t.shape) == (7, 5, 4)
    assert rel_l2_err(y_t.numpy(), y_j) <= tol.MLP_INFER_REL
    module = tmlp.MLP(tp)
    with torch.no_grad():
        np.testing.assert_array_equal(module(torch.tensor(x)).numpy(), y_t.numpy())
    assert {k for k, _ in module.named_parameters()} == {"W1", "b1", "W2", "b2"}


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n.name)
def test_grid_infer_and_generate_fields_match_jax(norm):
    g = GridSpec(nx=24, ny=8, nz=5, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp, tp = _params()
    y_j = jfields.grid_infer(_jax(g), _jax(cfg), jp, 0.3)
    y_t = tfields.grid_infer(g, cfg, tp, 0.3)
    assert rel_l2_err(y_t.numpy(), np.asarray(y_j)) <= tol.MLP_INFER_REL
    s_t, u_t = tfields.split_channels(y_t)
    s_j, u_j = jfields.split_channels(y_j)
    np.testing.assert_array_equal(s_t.numpy(), y_t[..., 0].numpy())
    assert tuple(u_t.shape) == tuple(u_j.shape) == (3,) + g.shape

    fs_j = jfields.generate_fields(_jax(g), _jax(cfg), jp, 0.25, g.dt)
    fs_t = tfields.generate_fields(g, cfg, tp, 0.25, g.dt)
    for name in fs_j._fields:
        a, b = getattr(fs_t, name).numpy(), np.asarray(getattr(fs_j, name))
        assert a.shape == b.shape
        assert rel_l2_err(a, b) <= tol.MLP_INFER_REL, name


def test_slice_times_round_like_jax():
    ts = tfields.slice_times(0.25, 1e-3)
    t, dt = jnp.float32(0.25), jnp.float32(1e-3)
    np.testing.assert_array_equal(ts, np.asarray(jnp.stack([t - dt, t, t + dt])))
