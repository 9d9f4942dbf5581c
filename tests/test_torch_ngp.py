"""The port's encoded-field model (phys_autodiff_tpu_torch/models/ngp.py) vs
the JAX package's models/ngp.py, on tests/test_mega_ngp.py's ENC (one hashed
and two dense levels, LF = 6, hidden 16) at 128x8x6 (shaped) and 64x16x6
(flat), and on a Fourier encoding.

init_ngp_params draws the same numpy streams: bitwise equal. The fields are
float32 programs of the same arithmetic (the encoder, then the head's
matmuls in full float32), held to MLP_INFER_REL (1e-6, the coordinate
MLP's inference bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.pallas import residuals as jres
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.kernels.residuals import pack_fields
from phys_autodiff_tpu_torch.models import ngp
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.tolerances import MLP_INFER_REL
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jfourier, jngp)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


ENC = HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                         dense_oversubscribed=True)
CFGS = {
    "hash": ngp.NGPFieldConfig(encoding=ENC, hidden=16),
    "fourier": ngp.NGPFieldConfig(encoding=FourierEncodingConfig(num_frequencies=2), hidden=16),
}
GRIDS = {"shaped": dict(nx=128, ny=8, nz=6), "flat": dict(nx=64, ny=16, nz=6)}


def _params(cfg, seed=7):
    """Both packages' params from one draw, conditioned as
    tests/test_mega_ngp.py does (O(1) features, random biases)."""
    jp = jngp.init_ngp_params(_jax(cfg), seed=seed)
    rng = np.random.Generator(np.random.MT19937(21))
    jp["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jp["tables"])
    jp["b1"] = jnp.asarray(rng.standard_normal(jp["b1"].shape) * 0.3, jnp.float32)
    jp["b2"] = jnp.asarray(rng.standard_normal(jp["b2"].shape) * 0.3, jnp.float32)
    return jp, ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _close(a, b, rel=MLP_INFER_REL):
    a, b = a.detach().numpy(), np.asarray(b)
    assert a.shape == b.shape
    assert rel_l2_err(a, b) <= rel


@pytest.mark.parametrize(
    "cfg",
    [CFGS["hash"], CFGS["fourier"], ngp.NGPFieldConfig()],
    ids=["dense-mix", "fourier", "flagship"],
)
def test_init_ngp_params_is_bitwise_the_jax_draw(cfg):
    jp = jngp.init_ngp_params(_jax(cfg), seed=777)
    tp = ngp.init_ngp_params(cfg, seed=777, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree.leaves(tp)
    assert str(jax.tree_util.tree_structure(jp)).count("*") == len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ngp.checkpoint_meta(cfg) == jngp.checkpoint_meta(_jax(cfg))
    assert cfg.head_in == _jax(cfg).head_in


def test_params_cross_both_ways():
    jp, tp = _params(CFGS["hash"])
    assert set(tp) == {"tables", "W1", "b1", "W2", "b2"} and set(tp["tables"]["dense"]) == {"l1", "l2"}
    back = ngp.params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jf, tf = _params(CFGS["fourier"])
    assert tuple(tf["tables"].shape) == (0,) and ngp.params_to_numpy(tf)["tables"].shape == (0,)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("name", list(CFGS))
def test_grid_infer_and_generate_fields_match_jax(name, grid):
    cfg = CFGS[name]
    g = GridSpec(**GRIDS[grid], hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    jp, tp = _params(cfg)
    _close(ngp.grid_infer(g, cfg, tp, 0.3), jngp.grid_infer(_jax(g), _jax(cfg), jp, 0.3))
    fs_t = ngp.generate_fields(g, cfg, tp, 0.3, g.dt)
    fs_j = jngp.generate_fields(_jax(g), _jax(cfg), jp, 0.3, g.dt)
    for name_ in fs_j._fields:
        _close(getattr(fs_t, name_), getattr(fs_j, name_))
    packed = ngp.generate_fields_packed(g, cfg, tp, 0.3, g.dt)
    _close(packed, jngp.generate_fields_packed(_jax(g), _jax(cfg), jp, 0.3, g.dt))
    # the packed layout is PACKED_ORDER of the same fields
    _close(packed, pack_fields(fs_t).numpy(), rel=1e-7)
    _close(packed, jres.pack_fields(fs_j))


def test_pointwise_forward_matches_jax_and_grid_infer():
    cfg = CFGS["hash"]
    jp, tp = _params(cfg)
    coords = np.random.default_rng(3).uniform(0, 1, (5, 11, 3)).astype(np.float32)
    y_t = ngp.forward(cfg, tp, torch.tensor(coords), 0.4)
    _close(y_t, jngp.forward(_jax(cfg), jp, jnp.asarray(coords), 0.4))
    g = GridSpec(nx=9, ny=5, nz=4)
    y_grid = ngp.grid_infer(g, cfg, tp, 0.4)
    y_pts = ngp.forward(cfg, tp, ngp._unit_coords(g, "cpu"), 0.4)
    # the grid encoder builds its weights in float64: ~R * eps_f32 apart
    assert rel_l2_err(y_grid.detach().numpy(), y_pts.detach().numpy()) <= 1e-5


def test_head_base_factoring_matches_apply_head():
    """generate_fields' shared layer-1 base + rank-1 time term equals the
    time channel concatenated into W1 (one float32 reassociation apart)."""
    cfg = CFGS["hash"]
    _, tp = _params(cfg)
    g = GridSpec(nx=16, ny=8, nz=5, dt=1e-2)
    fs = ngp.generate_fields(g, cfg, tp, 0.25, g.dt)
    y = ngp.grid_infer(g, cfg, tp, 0.25)
    _close(fs.sigma_t, y[..., 0].numpy())
    _close(fs.u_t, torch.movedim(y[..., 1:4], -1, 0).numpy())


def test_tensor_t_gets_a_gradient_and_unported_tiers_raise():
    cfg = CFGS["hash"]
    _, tp = _params(cfg)
    g = GridSpec(nx=16, ny=8, nz=5, dt=1e-2)
    t = torch.tensor(0.25, requires_grad=True)
    fs = ngp.generate_fields(g, cfg, tp, t, g.dt)
    (d_t,) = torch.autograd.grad(fs.sigma_tp1.sum(), t)
    assert torch.isfinite(d_t) and float(d_t) != 0.0
    # the head's tiers: bf16 rounds, f32_fastbwd is f32 there; unknown names raise
    f32 = ngp.generate_fields(g, cfg, tp, 0.25, g.dt)
    assert not torch.equal(ngp.generate_fields(g, cfg, tp, 0.25, g.dt, "bf16").sigma_t, f32.sigma_t)
    assert torch.equal(ngp.generate_fields(g, cfg, tp, 0.25, g.dt, "f32_fastbwd").sigma_t, f32.sigma_t)
    with pytest.raises(ValueError, match="unknown precision"):
        ngp.generate_fields(g, cfg, tp, 0.25, g.dt, "tf32")
