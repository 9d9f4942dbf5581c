"""The port's staged ops (phys_autodiff_tpu_torch/ops) vs the JAX staged
ops on the same numpy inputs.

Both arms round after every float32 operation in the same order, so the
residuals and backward are held to the fused-vs-staged class
(utils/tolerances.py FUSED_VS_STAGED_REL / _MAX); losses reduced in another
order to 1e-6 relative; autograd through the port vs jax.grad to GRAD_REL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.ops import loss as jloss
from phys_autodiff_tpu.ops import stencil as jstencil
from phys_autodiff_tpu.ref import manufactured
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, PhysWeights
from phys_autodiff_tpu_torch import ops as tops
from phys_autodiff_tpu_torch.ops import stencil as tstencil
from phys_autodiff_tpu_torch.ref import oracle
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

torch.set_num_threads(1)

GRIDS = {
    "plane": dict(nx=24, ny=16, nz=6),
    "nz1": dict(nx=16, ny=8, nz=1),
    "odd": dict(nx=7, ny=5, nz=3),
}


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    return getattr(jconfig, type(x).__name__)(**dataclasses.asdict(x))


def _spec(dims, periodic=True, scheme="central"):
    # Spacings near 1 keep the residuals O(1), where FUSED_VS_STAGED_MAX
    # (absolute) is a few ulp.
    return GridSpec(**dims, hx=0.5, hy=0.6, hz=0.7, dt=0.5, periodic=periodic, scheme=scheme)


def _random_fields(g, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    return dict(
        sigma_tm1=mk(g.shape), sigma_t=mk(g.shape), sigma_tp1=mk(g.shape),
        u_tm1=mk((3,) + g.shape), u_t=mk((3,) + g.shape), u_tp1=mk((3,) + g.shape),
    )


def _both(f):
    return (
        jstencil.FieldSnapshots(**{k: jnp.asarray(v) for k, v in f.items()}),
        tstencil.FieldSnapshots(**{k: torch.tensor(v) for k, v in f.items()}),
    )


def _close(a, b, rel=tol.FUSED_VS_STAGED_REL, mx=tol.FUSED_VS_STAGED_MAX):
    a, b = np.asarray(a.detach().numpy() if torch.is_tensor(a) else a), np.asarray(b)
    assert a.shape == b.shape
    assert rel_l2_err(a, b) <= rel
    assert max_abs_err(a, b) <= mx


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_residuals_match_jax_staged(grid, periodic, scheme):
    g = _spec(GRIDS[grid], periodic, scheme)
    jf, tf = _both(_random_fields(g, seed=len(grid)))
    rs_j, ru_j = jops.residuals(_jax(g), jf)
    rs_t, ru_t = tops.residuals(g, tf)
    _close(rs_t, rs_j)
    _close(ru_t, ru_j)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shift_and_differences_match_jax(periodic, delta, axis):
    f = np.random.default_rng(axis).standard_normal((5, 4, 6)).astype(np.float32)
    a = np.random.default_rng(9).standard_normal((5, 4, 6)).astype(np.float32)
    ft, at = torch.tensor(f), torch.tensor(a)
    np.testing.assert_array_equal(
        tstencil.shift(ft, delta, axis, periodic).numpy(),
        np.asarray(jstencil.shift(jnp.asarray(f), delta, axis, periodic)),
    )
    inv = tstencil.inv2h_f32(0.05)
    assert inv == jstencil.inv2h_f32(0.05)
    _close(tstencil.central_diff(ft, axis, inv, periodic),
           jstencil.central_diff(jnp.asarray(f), axis, inv, periodic))
    _close(tstencil.upwind_diff(ft, at, axis, 2 * inv, periodic),
           jstencil.upwind_diff(jnp.asarray(f), jnp.asarray(a), axis, 2 * inv, periodic))


def test_residuals_and_f64_loss_match_the_oracle():
    """Manufactured solution 1 through the port vs the f64 oracle, at the
    f32-vs-oracle tolerances (R_sigma loose for the time-difference
    cancellation, R_u tight) and LOSS_REL for the f64-reduced loss."""
    jg = manufactured.periodic_box_spec()
    f = manufactured.solution1_fields(jg, 1.2345)
    g = GridSpec(**dataclasses.asdict(jg))
    _, tf = _both(f)
    rs_o, ru_o = oracle.residuals(g, **f)
    rs_t, ru_t = tops.residuals(g, tf)
    assert rel_l2_err(rs_t.numpy(), rs_o) <= tol.F32_VS_ORACLE_RSIGMA_REL
    assert max_abs_err(rs_t.numpy(), rs_o) <= tol.F32_VS_ORACLE_RSIGMA_MAX
    assert np.max(np.abs(ru_o)) == 0.0  # u is constant: R_u vanishes
    assert max_abs_err(ru_t.numpy(), ru_o) <= tol.F32_VS_ORACLE_RU_MAX
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    ls_o, lu_o = oracle.loss_forward(g, w, **f)
    ls, lu = tops.loss_forward_f64(g, w, tf)
    assert abs(float(ls) - float(ls_o)) / abs(float(ls_o)) <= tol.LOSS_REL
    assert abs(float(lu) - float(lu_o)) <= 1e-10


@pytest.mark.parametrize("grid", ["plane", "nz1"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_losses_match_jax(grid, scheme):
    g = _spec(GRIDS[grid], periodic=grid == "plane", scheme=scheme)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    jf, tf = _both(_random_fields(g, seed=3))

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    # Held to the JAX f64-reduced loss: f32 reductions at 1e-6 (the CPU
    # backend of JAX adds f32 sums sequentially, so its own f32 loss is not
    # the referee), the port's f64 reduction at LOSS_REL.
    ref = jops.loss_forward_f64(_jax(g), _jax(w), jf)
    for port in (tops.loss_forward(g, w, tf), tops.loss_forward_planewise(g, w, tf)):
        assert rel(port[0], ref[0]) <= 1e-6 and rel(port[1], ref[1]) <= 1e-6
    port = tops.loss_forward_f64(g, w, tf)
    assert rel(port[0], ref[0]) <= tol.LOSS_REL and rel(port[1], ref[1]) <= tol.LOSS_REL
    assert rel(tops.total_loss(g, w, tf), float(ref[0]) + float(ref[1])) <= 1e-6

    rs_t, ru_t = tops.residuals(g, tf)
    rs_j, ru_j = jops.residuals(_jax(g), jf)
    parts_t = tops.plane_partials(rs_t, ru_t)
    parts_j = jloss.plane_partials(rs_j, ru_j)
    r64 = np.asarray(rs_j, np.float64), np.asarray(ru_j, np.float64)
    parts64 = np.stack([np.sum(r64[0] ** 2, axis=(1, 2)), np.sum(r64[1] ** 2, axis=(0, 2, 3))])
    assert parts_t.shape == (2, g.nz)
    assert rel_l2_err(parts_t.numpy(), parts64) <= 1e-6
    # sum_partials adds in the same sequential order: identical on equal input
    s_t = tops.sum_partials(g, w, torch.tensor(np.asarray(parts_j)))
    s_j = jloss.sum_partials(_jax(g), _jax(w), parts_j)
    assert float(s_t[0]) == float(s_j[0]) and float(s_t[1]) == float(s_j[1])
    for a, b in zip(tops.loss_terms(g, w, rs_t, ru_t), ref):
        assert rel(a, b) <= 1e-6
    for a, b in zip(tops.loss_backward(g, w, rs_t, ru_t), jops.loss_backward(_jax(g), _jax(w), rs_j, ru_j)):
        _close(a, b)


@pytest.mark.parametrize(
    "scheme, periodic", [("central", True), ("upwind", False)], ids=["central-periodic", "upwind-clamp"]
)
def test_autograd_field_adjoint_matches_jax_grad(scheme, periodic):
    g = _spec(GRIDS["odd"], periodic, scheme)
    w = PhysWeights(w_sigma=1.1, w_u=0.9)
    f = _random_fields(g, seed=5)
    jf, _ = _both(f)
    tf = tstencil.FieldSnapshots(**{k: torch.tensor(v, requires_grad=True) for k, v in f.items()})
    tops.total_loss(g, w, tf).backward()
    gj = jax.grad(lambda x: jops.total_loss(_jax(g), _jax(w), x))(jf)
    for name in tf._fields:
        a = getattr(tf, name).grad.numpy()
        b = np.asarray(getattr(gj, name))
        assert rel_l2_err(a, b) <= tol.GRAD_REL, name
