"""K2 (phys_autodiff_tpu_torch/kernels/mlp.py) vs the JAX fused MLP kernel.

On the CPU the port's wrappers run the kernel's plain version (the table
MLP). At nx=128 the JAX "fused" functions run their Pallas kernel in
interpret mode; at other nx they run the JAX staged path (their TPU gate),
so the port is held to that there. Fields: MLP_INFER_REL; the fused loss:
1e-6 relative to the f64-reduced loss of the same fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import fields as jfields
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.pallas import mlp as jpm
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch import ops as tops
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

G128 = GridSpec(nx=128, ny=16, nz=8, dt=1e-3)
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


def _params(h=32, seed=123):
    jp = jmlp.init_params(_jax(MLPDims(H=h)), seed=seed, scale=0.25)
    return jp, tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _fields_close(fs_t, fs_j):
    for name in fs_j._fields:
        a, b = getattr(fs_t, name).numpy(), np.asarray(getattr(fs_j, name))
        assert a.shape == b.shape, name
        assert rel_l2_err(a, b) <= tol.MLP_INFER_REL, name


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n.name)
def test_generate_fields_fused_matches_pallas(norm):
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp, tp = _params()
    _fields_close(
        kmlp.generate_fields_fused(G128, cfg, tp, 0.25), jpm.generate_fields_fused(_jax(G128), _jax(cfg), jp, 0.25)
    )


def test_packed_and_grid_infer_match_pallas():
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    jp, tp = _params()
    p_t = kmlp.generate_fields_fused_packed(G128, cfg, tp, 0.25)
    p_j = jpm.generate_fields_fused_packed(_jax(G128), _jax(cfg), jp, 0.25)
    assert tuple(p_t.shape) == (12,) + G128.shape
    assert rel_l2_err(p_t.numpy(), np.asarray(p_j)) <= tol.MLP_INFER_REL
    # the packed layout is PACKED_ORDER of the same fields
    fs = kmlp.generate_fields_fused(G128, cfg, tp, 0.25)
    np.testing.assert_array_equal(p_t.numpy(), kres.pack_fields(fs).numpy())
    y_t = kmlp.grid_infer_fused(G128, cfg, tp, 0.3)
    y_j = jpm.grid_infer_fused(_jax(G128), _jax(cfg), jp, 0.3)
    assert tuple(y_t.shape) == G128.shape + (4,)
    assert rel_l2_err(y_t.numpy(), np.asarray(y_j)) <= tol.MLP_INFER_REL


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n.name)
@pytest.mark.parametrize("dims", [(24, 8, 4), (16, 8, 1), (5, 3, 2)], ids=["nx24", "nz1", "odd"])
def test_any_grid_matches_jax_staged(norm, dims):
    nx, ny, nz = dims
    g = GridSpec(nx=nx, ny=ny, nz=nz, dt=1e-3)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp, tp = _params(seed=7)
    _fields_close(
        kmlp.generate_fields_fused(g, cfg, tp, 0.1), jfields.generate_fields(_jax(g), _jax(cfg), jp, 0.1, g.dt)
    )
    y_t = kmlp.grid_infer_fused(g, cfg, tp, 0.1)
    assert rel_l2_err(y_t.numpy(), np.asarray(jfields.grid_infer(_jax(g), _jax(cfg), jp, 0.1))) <= tol.MLP_INFER_REL


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n.name)
def test_folded_tables_match_jax(norm):
    g = GridSpec(nx=24, ny=8, nz=5)
    cfg = MLPGridConfig(dims=MLPDims(H=16), norm=norm)
    jp, tp = _params(h=16)
    ts_j = jnp.stack([jnp.float32(0.2), jnp.float32(0.25), jnp.float32(0.3)])
    ab_t, cd_t, w2t_t, b2_t = kmlp.fold_tables(g, cfg, tp, np.asarray(ts_j))
    np.testing.assert_array_equal(ab_t.numpy(), np.asarray(jpm.fold_ab_plane(_jax(g), _jax(cfg), jp)))
    np.testing.assert_array_equal(cd_t.numpy(), np.asarray(jpm.fold_cd(_jax(g), _jax(cfg), jp, ts_j)))
    assert tuple(w2t_t.shape) == (4, 16) and tuple(b2_t.shape) == (4,)
    assert all(t.is_contiguous() for t in (ab_t, cd_t, w2t_t, b2_t))


def test_fused_loss_pipeline_matches_pallas_and_f64():
    g = GridSpec(nx=128, ny=8, nz=6, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    jp, tp = _params()
    port = kmlp.fused_loss_pipeline(g, w, cfg, tp, 0.25)
    pal = jpm.fused_loss_pipeline(_jax(g), _jax(w), _jax(cfg), jp, 0.25)
    ref_t = tops.loss_forward_f64(g, w, kmlp.generate_fields_fused(g, cfg, tp, 0.25))
    ref_j = jops.loss_forward_f64(_jax(g), _jax(w), jpm.generate_fields_fused(_jax(g), _jax(cfg), jp, 0.25))
    for k in range(2):
        assert abs(float(port[k]) - float(ref_t[k])) <= 1e-6 * abs(float(ref_t[k]))
        assert abs(float(port[k]) - float(pal[k])) <= 1e-5 * abs(float(pal[k]))
        assert abs(float(ref_t[k]) - float(ref_j[k])) <= 1e-5 * abs(float(ref_j[k]))
