"""Autograd through the port's kernel wrappers K1, K2, K3 (and the F1
repair: gradients with respect to t) vs jax.grad of the JAX package.

Each wrapper is a torch.autograd.Function whose backward is autograd
through the staged ops, as each JAX custom_vjp is jax.vjp of its staged
path; on the CPU its forward runs the kernel's plain version. Tolerances:

  * K1 field gradients: GRAD_REL (1e-6), both sides being the staged
    adjoint in float32 (tests/test_fused_vs_staged.py:102 holds JAX's
    fused-vs-staged at 1e-7 within one framework; across frameworks the
    summation order of the reductions differs);
  * K2 / K3 / pipeline parameter gradients: 1e-4 relative on the
    concatenation, t gradients 1e-3 (the cotangents come from forward
    values that agree to MLP_INFER_REL, and the gradients sum over the
    grid in another order: the test_mega_bwd.py doctrine).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import generate_fields as jgenerate
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.ops.stencil import FieldSnapshots as JFields
from phys_autodiff_tpu.pallas import residuals as jres
from phys_autodiff_tpu.pallas.mega import mega_loss_pipeline as jmega
from phys_autodiff_tpu.pallas.mlp import generate_fields_fused_packed as jgen_packed
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch import ops as tops
from phys_autodiff_tpu_torch.kernels import mega as kmega
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots as TFields
from phys_autodiff_tpu_torch.utils import tolerances as tol

torch.set_num_threads(1)

W = PhysWeights(w_sigma=1.3, w_u=0.7)
MLP_GRID = dict(nx=128, ny=8, nz=6, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    fields = {f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return getattr(jconfig, type(x).__name__)(**fields)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    return np.concatenate([np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)])


def _fields_np(g, seed=0):
    rng = np.random.default_rng(seed)
    s = lambda: rng.uniform(-1, 1, g.shape).astype(np.float32)  # noqa: E731
    v = lambda: rng.uniform(-1, 1, (3,) + g.shape).astype(np.float32)  # noqa: E731
    return [s(), s(), s(), v(), v(), v()]


def _leaf(x):
    return torch.tensor(x, requires_grad=True)


# ---------------------------------------------------------------------------
# K1: residuals and loss forward, six arrays and packed
# ---------------------------------------------------------------------------

K1_CASES = [(True, "central"), (False, "upwind")]
K1_IDS = ["periodic-central", "clamp-upwind"]


def _k1_grid(periodic, scheme):
    return GridSpec(nx=24, ny=16, nz=6, hx=0.5, hy=0.6, hz=0.7, dt=0.5, periodic=periodic, scheme=scheme)


@pytest.mark.parametrize("periodic, scheme", K1_CASES, ids=K1_IDS)
def test_residuals_fused_field_gradients_match_jax(periodic, scheme):
    g = _k1_grid(periodic, scheme)
    f_np = _fields_np(g)
    rng = np.random.default_rng(1)
    ct_np = (rng.standard_normal(g.shape).astype(np.float32),
             rng.standard_normal((3,) + g.shape).astype(np.float32))
    _, vjp = jax.vjp(lambda f: jres.residuals_fused(_jax(g), f, True), JFields(*f_np))
    (ref,) = vjp(tuple(jnp.asarray(c) for c in ct_np))
    fs = TFields(*[_leaf(x) for x in f_np])
    out = kres.residuals_fused(g, fs)
    grads = torch.autograd.grad(out, list(fs), [torch.tensor(c) for c in ct_np])
    for name, a, b in zip(JFields._fields, grads, ref):
        assert _rel(a.numpy(), b) <= tol.GRAD_REL, name

    packed = _leaf(np.concatenate([f_np[0][None], f_np[1][None], f_np[2][None], *f_np[3:]]))
    out = kres.residuals_fused_packed(g, packed)
    (d_packed,) = torch.autograd.grad(out, packed, torch.tensor(np.concatenate([ct_np[0][None], ct_np[1]])))
    ref_packed = jres.pack_fields(ref)
    assert _rel(d_packed.numpy(), ref_packed) <= tol.GRAD_REL


@pytest.mark.parametrize("periodic, scheme", K1_CASES, ids=K1_IDS)
def test_loss_forward_fused_field_gradients_match_jax(periodic, scheme):
    g = _k1_grid(periodic, scheme)
    f_np = _fields_np(g, seed=2)

    def jloss(f):  # the JAX loss kernel with a custom_vjp is the packed one
        ls, lu = jres.loss_forward_fused_packed(_jax(g), _jax(W), jres.pack_fields(f), True)
        return 0.75 * ls + lu

    ref = jax.grad(jloss)(JFields(*f_np))
    fs = TFields(*[_leaf(x) for x in f_np])
    ls, lu = kres.loss_forward_fused(g, W, fs)
    grads = torch.autograd.grad(0.75 * ls + lu, list(fs))
    for name, a, b in zip(JFields._fields, grads, ref):
        assert _rel(a.numpy(), b) <= tol.GRAD_REL, name

    packed = kres.pack_fields(TFields(*[torch.tensor(x) for x in f_np])).requires_grad_()
    ls, lu = kres.loss_forward_fused_packed(g, W, packed)
    (d_packed,) = torch.autograd.grad(0.75 * ls + lu, packed)
    assert _rel(d_packed.numpy(), jres.pack_fields(ref)) <= tol.GRAD_REL


# ---------------------------------------------------------------------------
# K2, K3 and the K2 -> K1 pipeline: gradients into the params and t
# ---------------------------------------------------------------------------


def _mlp_setup(periodic=True, scheme="central", norm=CoordNorm.MinusOneToOne, seed=3):
    g = GridSpec(periodic=periodic, scheme=scheme, **MLP_GRID)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp = jmlp.init_params(_jax(cfg.dims), seed=seed)
    tp = tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    return g, cfg, jp, tp


def _assert_grads(port_p, port_t, ref_p, ref_t):
    port_p = {k: v.numpy() for k, v in port_p.items()}
    assert _rel(_cat(port_p), _cat(ref_p)) < 1e-4
    assert abs(float(port_t) - float(ref_t)) <= 1e-3 * abs(float(ref_t))


def _port_grads(loss, tp, t):
    grads = torch.autograd.grad(loss, list(tp.values()) + [t])
    return dict(zip(tp, grads[:4])), grads[4]


@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne])
def test_generate_fields_fused_gradients_match_jax(norm):
    """Packed K2 under a weighted sum: gradients into the params and t vs
    jax.grad through the JAX kernel's custom_vjp (tests/test_mlp_fused.py:74
    is the JAX counterpart)."""
    g, cfg, jp, tp = _mlp_setup(norm=norm)
    weights_np = np.random.default_rng(4).standard_normal((12,) + g.shape).astype(np.float32)

    def jobj(p, tt):
        return jnp.sum(jnp.asarray(weights_np) * jgen_packed(_jax(g), _jax(cfg), p, tt, "f32", True))

    ref_p, ref_t = jax.grad(jobj, argnums=(0, 1))(jp, jnp.float32(0.25))
    t = torch.tensor(0.25, requires_grad=True)
    obj = torch.sum(torch.tensor(weights_np) * kmlp.generate_fields_fused_packed(g, cfg, tp, t))
    _assert_grads(*_port_grads(obj, tp, t), ref_p, ref_t)

    # the six-array form is the same Function: same gradients
    fs = kmlp.generate_fields_fused(g, cfg, tp, t)
    obj6 = torch.sum(torch.tensor(weights_np) * kres.pack_fields(fs))
    _assert_grads(*_port_grads(obj6, tp, t), ref_p, ref_t)


@pytest.mark.parametrize("periodic, scheme", [(True, "central"), (False, "upwind")],
                         ids=["periodic-central", "clamp-upwind"])
def test_mega_loss_pipeline_gradients_match_jax(periodic, scheme):
    g, cfg, jp, tp = _mlp_setup(periodic=periodic, scheme=scheme)

    def jloss(p, tt):
        ls, lu = jmega(_jax(g), _jax(W), _jax(cfg), p, tt, "f32", True)
        return ls + lu

    ref_p, ref_t = jax.grad(jloss, argnums=(0, 1))(jp, jnp.float32(0.25))
    t = torch.tensor(0.25, requires_grad=True)
    ls, lu = kmega.mega_loss_pipeline(g, W, cfg, tp, t)
    _assert_grads(*_port_grads(ls + lu, tp, t), ref_p, ref_t)


def test_fused_loss_pipeline_gradients_match_staged():
    """K2 -> K1 differentiates by composition of their Functions."""
    g, cfg, jp, tp = _mlp_setup(periodic=False)

    def staged(p, tt):
        return jops.total_loss(_jax(g), _jax(W), jgenerate(_jax(g), _jax(cfg), p, tt, g.dt))

    ref_p, ref_t = jax.grad(staged, argnums=(0, 1))(jp, jnp.float32(0.3))
    t = torch.tensor(0.3, requires_grad=True)
    ls, lu = kmlp.fused_loss_pipeline(g, W, cfg, tp, t)
    _assert_grads(*_port_grads(ls + lu, tp, t), ref_p, ref_t)


# ---------------------------------------------------------------------------
# F1: the port differentiates with respect to t
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne])
def test_staged_loss_gradient_in_t_matches_jax(norm):
    """A tensor t reaches autograd through models.fields.slice_times (it
    was turned into host floats, and backward raised); d_t vs
    jax.grad(..., argnums=1) of the JAX staged loss."""
    g, cfg, jp, tp = _mlp_setup(norm=norm, periodic=False)

    def staged(p, tt):
        return jops.total_loss(_jax(g), _jax(W), jgenerate(_jax(g), _jax(cfg), p, tt, g.dt))

    ref_t = jax.grad(staged, argnums=1)(jp, jnp.float32(0.25))
    t = torch.tensor(0.25, requires_grad=True)
    loss = tops.total_loss(g, W, tfields.generate_fields(g, cfg, tp, t, g.dt))
    (d_t,) = torch.autograd.grad(loss, t)
    assert abs(float(d_t) - float(ref_t)) <= 1e-3 * abs(float(ref_t))


def test_slice_times_of_a_tensor_round_like_the_host_values():
    for t, dt in ((0.25, 1e-3), (0.1, 1e-2), (0.7, 3e-3)):
        host = tfields.slice_times(t, dt)
        dev = tfields.slice_times(torch.tensor(t, dtype=torch.float32), dt)
        np.testing.assert_array_equal(dev.numpy(), host)
        np.testing.assert_array_equal(host, np.asarray(jnp.stack(
            [jnp.float32(t) - jnp.float32(dt), jnp.float32(t), jnp.float32(t) + jnp.float32(dt)])))
    g, cfg, _, tp = _mlp_setup()
    ts = tfields.slice_times(torch.tensor(0.25), g.dt)
    for a, b in zip(kmlp.fold_tables(g, cfg, tp, ts), kmlp.fold_tables(g, cfg, tp, tfields.slice_times(0.25, g.dt))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# models/mlp.py: the reference's MSE head
# ---------------------------------------------------------------------------


def test_mse_loss_and_grads_match_jax():
    dims = MLPDims(H=16)
    jp = jmlp.init_params(_jax(dims), seed=5)
    tp = tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    l_ref = jmlp.mse_loss(jp, jnp.asarray(x), jnp.asarray(y))
    g_ref = jmlp.mse_grads(jp, jnp.asarray(x), jnp.asarray(y))
    l = tmlp.mse_loss(tp, torch.tensor(x), torch.tensor(y))
    grads = tmlp.mse_grads(tp, torch.tensor(x), torch.tensor(y))
    assert abs(float(l) - float(l_ref)) <= tol.LOSS_REL * 10 * abs(float(l_ref))
    for k in g_ref:
        assert _rel(grads[k].numpy(), g_ref[k]) <= tol.GRAD_REL, k
