"""K1 (phys_autodiff_tpu_torch/kernels/residuals.py) vs the JAX fused
residual kernels.

On the CPU the port's wrappers run the kernel's plain version; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. Grids are the JAX tests' (tests/test_fused_vs_staged.py:33-37) plus
nz=1; the central/upwind x periodic/clamp matrix is held to the JAX staged
ops (the Pallas kernels' own referee). Residuals and g: FUSED_VS_STAGED_*;
losses: 1e-6 relative to the f64-reduced loss.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.ops.stencil import FieldSnapshots as JFields
from phys_autodiff_tpu.pallas import residuals as jres
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, PhysWeights
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots as TFields
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

torch.set_num_threads(1)

SLAB_GRID = dict(nx=128, ny=16, nz=8)
PLANE_GRID = dict(nx=24, ny=16, nz=6)
NZ1_GRID = dict(nx=16, ny=8, nz=1)
W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    return getattr(jconfig, type(x).__name__)(**dataclasses.asdict(x))


def _spec(dims, periodic=True, scheme="central"):
    # spacings near 1 keep R O(1), where FUSED_VS_STAGED_MAX is a few ulp
    return GridSpec(**dims, hx=0.5, hy=0.6, hz=0.7, dt=0.5, periodic=periodic, scheme=scheme)


def _fields(g, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    f = dict(
        sigma_tm1=mk(g.shape), sigma_t=mk(g.shape), sigma_tp1=mk(g.shape),
        u_tm1=mk((3,) + g.shape), u_t=mk((3,) + g.shape), u_tp1=mk((3,) + g.shape),
    )
    return (
        JFields(**{k: jnp.asarray(v) for k, v in f.items()}),
        TFields(**{k: torch.tensor(v) for k, v in f.items()}),
    )


def _close(a, b):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape
    assert rel_l2_err(a, b) <= tol.FUSED_VS_STAGED_REL
    assert max_abs_err(a, b) <= tol.FUSED_VS_STAGED_MAX


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("dims", [SLAB_GRID, PLANE_GRID], ids=["slab", "plane"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_residuals_fused_matches_pallas(dims, periodic):
    g = _spec(dims, periodic)
    jf, tf = _fields(g)
    rs_j, ru_j = jres.residuals_fused(_jax(g), jf)
    rs_t, ru_t = kres.residuals_fused(g, tf)
    _close(rs_t, rs_j)
    _close(ru_t, ru_j)


def test_loss_backward_and_forward_fused_match_pallas():
    g = _spec(PLANE_GRID, scheme="upwind")
    jf, tf = _fields(g, seed=1)
    gs_j, gu_j = jres.loss_backward_fused(_jax(g), _jax(W), jf)
    gs_t, gu_t = kres.loss_backward_fused(g, W, tf)
    _close(gs_t, gs_j)
    _close(gu_t, gu_j)
    ref = jops.loss_forward_f64(_jax(g), _jax(W), jf)
    pal = jres.loss_forward_fused(_jax(g), _jax(W), jf)
    port = kres.loss_forward_fused(g, W, tf)
    for k in range(2):
        assert _rel(pal[k], ref[k]) <= 1e-6
        assert _rel(port[k], ref[k]) <= 1e-6


@pytest.mark.parametrize(
    "dims, periodic, scheme",
    [(SLAB_GRID, True, "central"), (PLANE_GRID, False, "upwind"), (NZ1_GRID, True, "upwind")],
    ids=["slab-periodic-central", "plane-clamp-upwind", "nz1-periodic-upwind"],
)
def test_packed_entry_points_match_pallas(dims, periodic, scheme):
    g = _spec(dims, periodic, scheme)
    jf, tf = _fields(g, seed=2)
    packed_j = jres.pack_fields(jf)
    packed_t = kres.pack_fields(tf)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    _close(kres.residuals_fused_packed(g, packed_t), jres.residuals_fused_packed(_jax(g), packed_j, True))
    _close(
        kres.loss_backward_fused_packed(g, W, packed_t),
        jres.loss_backward_fused_packed(_jax(g), _jax(W), packed_j, True),
    )
    ref = jops.loss_forward_f64(_jax(g), _jax(W), jf)
    port = kres.loss_forward_fused_packed(g, W, packed_t)
    assert _rel(port[0], ref[0]) <= 1e-6 and _rel(port[1], ref[1]) <= 1e-6


@pytest.mark.parametrize("dims", [PLANE_GRID, NZ1_GRID], ids=["plane", "nz1"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_scheme_boundary_matrix_matches_jax_staged(dims, periodic, scheme):
    g = _spec(dims, periodic, scheme)
    jf, tf = _fields(g, seed=3)
    rs_j, ru_j = jops.residuals(_jax(g), jf)
    rs_t, ru_t = kres.residuals_fused(g, tf)
    _close(rs_t, rs_j)
    _close(ru_t, ru_j)
    gs_j, gu_j = jops.loss_backward(_jax(g), _jax(W), rs_j, ru_j)
    gs_t, gu_t = kres.loss_backward_fused(g, W, tf)
    _close(gs_t, gs_j)
    _close(gu_t, gu_j)
    ref = jops.loss_forward_f64(_jax(g), _jax(W), jf)
    port = kres.loss_forward_fused(g, W, tf)
    assert _rel(port[0], ref[0]) <= 1e-6 and _rel(port[1], ref[1]) <= 1e-6


def test_packed_order_and_unpack():
    assert kres.PACKED_ORDER == jres.PACKED_ORDER
    g = _spec(NZ1_GRID)
    _, tf = _fields(g, seed=4)
    back = kres.unpack_fields(kres.pack_fields(tf))
    for name in tf._fields:
        assert torch.equal(getattr(back, name), getattr(tf, name))


def test_kernel_tiling_counts_plane_tiles():
    assert kres.num_tiles(_spec(SLAB_GRID)) == 4 * 2
    assert kres.num_tiles(_spec(PLANE_GRID)) == 1 * 2
    assert kres.num_tiles(GridSpec(nx=128, ny=96, nz=96)) == 4 * 12
