"""K5, the NGP backward mega-kernel (phys_autodiff_tpu_torch/kernels/mega_ngp.py),
vs the JAX kernel (pallas/mega_ngp.py, interpret mode) and
jax.value_and_grad of the JAX staged loss.

On the CPU the port runs the kernel's plain version: autograd through the
head, the staged residuals and the fixed-order loss, with the encoder's
pull-back by autograd. Setup and tolerances are those of
tests/test_mega_ngp.py:28-119: ENC (one hashed and two dense levels,
LF = 6, hidden 16), tables scaled to O(1) features and random biases; loss
1e-5 relative; every gradient leaf 1e-4 relative (periodic) or 5e-3
(clamp, ill-conditioned); d_t 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.pallas.mega_ngp import ngp_loss_and_grad as jngp_lg
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
from phys_autodiff_tpu_torch.models import encoders, ngp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.utils import tree

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
W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _setup(nx=128, ny=8, nz=6, periodic=True, scheme="central", encoding=ENC):
    g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.3, hy=0.3, hz=0.3, dt=1e-2, periodic=periodic, scheme=scheme)
    cfg = ngp.NGPFieldConfig(encoding=encoding, hidden=16)
    jp = jngp.init_ngp_params(_jax(cfg), seed=7)
    rng = np.random.Generator(np.random.MT19937(21))
    jp["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jp["tables"])
    jp["b1"] = jnp.asarray(rng.standard_normal(jp["b1"].shape) * 0.3, jnp.float32)
    jp["b2"] = jnp.asarray(rng.standard_normal(jp["b2"].shape) * 0.3, jnp.float32)
    return g, cfg, jp, ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _staged_ref(g, cfg, jp, t=0.3):
    def total(p, tt):
        ls, lu = jops.loss_forward(_jax(g), _jax(W), jngp.generate_fields(_jax(g), _jax(cfg), p, tt, g.dt))
        return ls + lu

    return jax.value_and_grad(total, argnums=(0, 1))(jp, jnp.float32(t))


def _leaf_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-30)


def _agree(port, ref, tol):
    (loss, (gp, d_t)), (loss_ref, (gp_ref, d_t_ref)) = port, ref
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    ref_leaves = jax.tree_util.tree_leaves_with_path(gp_ref)
    port_leaves = tree.leaves(gp)
    assert len(port_leaves) == len(ref_leaves)
    for (key, b), a in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == b.shape, jax.tree_util.keystr(key)
        assert _leaf_close(a.detach().numpy(), b, tol), jax.tree_util.keystr(key)
    assert abs(float(d_t) - float(d_t_ref)) <= max(5e-3 * abs(float(d_t_ref)), 1e-6)


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_ngp_loss_and_grad_matches_jax_kernel_and_staged_grad(periodic, scheme):
    g, cfg, jp, tp = _setup(periodic=periodic, scheme=scheme)
    tol = 1e-4 if periodic else 5e-3
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, 0.3)
    _agree(port, _staged_ref(g, cfg, jp), tol)
    _agree(port, jngp_lg(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.3), interpret=True), tol)
    # the plain version of the whole step (autograd of the staged pipeline)
    _agree(k5.ngp_loss_and_grad_plain(g, W, cfg, tp, 0.3), _staged_ref(g, cfg, jp), tol)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_fourier_arm_needs_no_encoding_cotangent(periodic, monkeypatch):
    """A parameter-free encoding: the head takes need_denc=False, and the
    empty tables get an empty zero gradient (tests/test_fourier.py:118)."""
    g, cfg, jp, tp = _setup(periodic=periodic, scheme="upwind", encoding=FourierEncodingConfig(num_frequencies=2))
    seen = []
    head = k5.head_loss_and_grad

    def spy(*args, need_denc=True):
        seen.append(need_denc)
        return head(*args, need_denc=need_denc)

    monkeypatch.setattr(k5, "head_loss_and_grad", spy)
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, 0.3)
    assert seen == [False]
    d_tables = port[1][0]["tables"]
    assert tuple(d_tables.shape) == (0,) and d_tables.dtype == torch.float32
    tol = 1e-4 if periodic else 5e-3
    _agree(port, _staged_ref(g, cfg, jp), tol)
    _agree(port, jngp_lg(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.3), interpret=True), tol)


def test_flat_grid_matches_jax_kernel():
    """64x16x6: the JAX kernel's flat plane layout (tests/test_mega_ngp.py:151)."""
    g, cfg, jp, tp = _setup(nx=64, ny=16, nz=6)
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, 0.3)
    _agree(port, jngp_lg(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.3), interpret=True), 1e-4)
    _agree(port, _staged_ref(g, cfg, jp), 1e-4)


@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_nz1_clamp_matches_the_staged_gradient(scheme):
    """nz = 1 with clamp boundaries: the forward z difference is identically
    0, so its adjoint is 0. The JAX kernel reuses mega_bwd's stage-3 adjoint,
    whose clamp z-edge legs get this case wrong (ROADMAP.md Queue C, R4 and
    R5), so the port is held to jax.grad of the staged loss, never to it.
    The JAX kernel's worst leaf is checked to be off there, so that R5 is
    re-read if the reference changes (`pytest -s` prints the errors)."""
    g, cfg, jp, tp = _setup(nx=16, ny=8, nz=1, periodic=False, scheme=scheme)
    staged = _staged_ref(g, cfg, jp)
    _agree(k5.ngp_loss_and_grad(g, W, cfg, tp, 0.3), staged, 5e-3)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    _, (gk, tk) = jngp_lg(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.3), interpret=True)
    _, (gs, ts) = staged
    errs = {jax.tree_util.keystr(k): rel(a, b)
            for (k, b), a in zip(jax.tree_util.tree_leaves_with_path(gs), jax.tree_util.tree_leaves(gk))}
    print(f"R5 {scheme}: the JAX kernel vs the staged gradient, per leaf {errs}, d_t {rel(tk, ts)}")
    assert max(errs.values()) > 1e-2


def test_head_gradients_pull_back_to_the_params():
    """The referee chip_smoke holds the kernel path to (ngp_loss_and_grad_ref:
    W1 and b1 whole from the head, the encoder's pull-back by autograd,
    d_t = W1[-1] . db1) equals autograd of the whole pipeline through the
    referee's fields."""
    g, cfg, _, tp = _setup(periodic=False, scheme="upwind")
    loss, (gp, d_t) = k5.ngp_loss_and_grad_ref(g, W, cfg, tp, 0.3)
    leaves = [x.clone().requires_grad_() for x in tree.leaves(tp)]
    p = tree.unflatten(tp, leaves)
    t = torch.tensor(0.3, requires_grad=True)
    enc = encoders.encode_grid_zcf(cfg.encoding, p["tables"], g)
    fields = k5.head_fields_ref(enc, p["W1"], p["b1"], p["W2"], p["b2"], slice_times(t, g.dt))
    parts = k5.ops_loss.plane_partials(*k5.ops_stencil.residuals(g, fields))
    ls, lu = k5.ops_loss.sum_partials(g, W, parts)
    (ls + lu).backward()
    assert float(loss) == float((ls.float() + lu.float()).detach())
    for a, x in zip(tree.leaves(gp), leaves):
        np.testing.assert_allclose(a.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-9)
    assert abs(float(d_t) - float(t.grad)) <= 1e-5 * abs(float(t.grad))


def _head_inputs(g, cfg, tp, t=0.3):
    enc = encoders.encode_grid_zcf(cfg.encoding, tp["tables"], g)
    return enc, tp["W1"], tp["b1"], tp["W2"], tp["b2"], slice_times(torch.tensor(t), g.dt)


def test_referee_fields_take_the_float32_values_and_float64_derivatives():
    """head_fields_ref: the values of the float32 forward; the derivatives of
    the float64 head (here, where no pre-activation lies within rounding of
    0, those of head_fields_plain run in float64)."""
    g, cfg, _, tp = _setup(nz=3)
    args = _head_inputs(g, cfg, tp)
    ref = k5.head_fields_ref(*args)
    for a, b in zip(ref, k5.head_fields_plain(*args)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.double().numpy(), rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(3)
    weights = [torch.tensor(rng.standard_normal(tuple(x.shape))) for x in ref]

    def grads(fields_fn, xs):
        xs = [x.detach().requires_grad_() for x in xs]
        out = fields_fn(*xs)
        return torch.autograd.grad(sum((f * c).sum() for f, c in zip(out, weights)), xs[:5])

    for a, b in zip(grads(k5.head_fields_ref, args), grads(k5.head_fields_plain, [x.double() for x in args])):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def test_cpu_head_is_the_float32_plain_version():
    """On the CPU the kernel's wrapper runs the float32 plain version (not
    the float64 referee), as backward="xla" and the JAX package compute."""
    g, cfg, _, tp = _setup(nz=3)
    args = _head_inputs(g, cfg, tp)
    loss, grads = k5.head_loss_and_grad(g, W, *args)
    loss_p, grads_p = k5.head_loss_and_grad_plain(g, W, *args)
    assert torch.equal(loss, loss_p)
    for a, b, like in zip(grads, grads_p, args):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(like.shape) and torch.equal(a, b)


def test_gates_take_every_grid_and_bound_lf_and_h():
    for kw in (dict(nx=7, ny=3, nz=1), dict(nx=1, ny=1, nz=1, periodic=False, scheme="upwind")):
        assert k5.ngp_supported(GridSpec(**kw))
    assert k5.smem_bytes(16, 64) == 104704
    assert k5.ngp_fits(16, 64) and k5.ngp_fits(39, 64) and k5.ngp_fits(32, 128)
    assert not k5.ngp_fits(65, 16) and not k5.ngp_fits(16, 257) and not k5.ngp_fits(64, 128)
    assert k5.ngp_fits(16, 180) and not k5.ngp_fits(16, 181) and k5.ngp_fits(64, 116) and not k5.ngp_fits(64, 117)
    # the bf16 tier's kernels (their own shared-memory layout) take every
    # shape the gate admits, and two blocks an SM at the flagship
    cap = k5.SMEM_LIMIT - k5.SMEM_STATIC
    assert all(max(k5.bf16_smem_bytes(lf, h)) <= cap for lf in range(1, 65) for h in range(1, 257)
               if k5.ngp_fits(lf, h, "bf16"))
    assert k5.bf16_smem_bytes(16, 64) == (20992, 62976)
    # the persistent grid: one block per 32 x 8 tile row, at most 264
    assert [k5.num_blocks(GridSpec(nx=nx, ny=ny, nz=nz)) for nx, ny, nz in ((128, 96, 96), (40, 9, 2), (7, 3, 1))] == [
        264, 8, 1]


def test_cpu_params_take_the_plain_version():
    _build.reset_launches()
    g, cfg, _, tp = _setup(nz=3)
    k5.ngp_loss_and_grad(g, W, cfg, tp, 0.25)
    assert _build.LAUNCHES["mega_ngp"] == 0


@pytest.mark.parametrize("precision", ["bf16", "f32_fastbwd"])
def test_unported_tiers_raise(precision):
    """K5's reduced tiers run (held to JAX in tests/test_torch_ngp_tiers.py);
    the float64 referee holds the f32 tier alone and raises for them."""
    g, cfg, _, tp = _setup(nz=3)
    loss, (grads, _) = k5.ngp_loss_and_grad(g, W, cfg, tp, 0.25, precision)
    _, (grads32, _) = k5.ngp_loss_and_grad(g, W, cfg, tp, 0.25)
    assert bool(torch.isfinite(loss)) and not torch.equal(grads["W2"], grads32["W2"])
    with pytest.raises(ValueError, match="f32 tier"):
        k5.ngp_loss_and_grad_ref(g, W, cfg, tp, 0.25, precision)


@pytest.mark.parametrize("tier", ["f32", "bf16", "f32_fastbwd"])
def test_plain_head_bits_do_not_depend_on_the_rows(tier):
    """The plain head (the referee of the kernel's tiers) on a subset of
    the rows gives the whole grid's bits on those rows: base, the fields of
    the three slices and dEnc are float64 sums of the products rounded once
    (k5._mm64), so a shard's plain version and the whole grid's agree to
    the bit on any machine, whatever order its float32 GEMM kernels take."""
    g, cfg, _, tp = _setup(nz=6)
    ts = torch.tensor([0.3 - g.dt, 0.3, 0.3 + g.dt])
    enc = encoders.encode_grid_zcf(cfg.encoding, tp["tables"], g)
    rows = torch.tensor([5, 0, 1, 2, 2])
    w1, b1, w2, b2 = tp["W1"], tp["b1"], tp["W2"], tp["b2"]
    arith = "bf16" if tier == "bf16" else "f32"
    base, base_sub = k5._base(enc, w1, arith), k5._base(enc[rows], w1, arith)
    assert torch.equal(base_sub, base[rows])
    tb1 = k5.first_layer_bias(w1, b1, ts)
    ys, ys_sub = k5._head_from_base(base, tb1, w2, b2, arithmetic=tier), k5._head_from_base(
        base_sub, tb1, w2, b2, arithmetic=tier)
    for y, y_sub in zip(ys, ys_sub):
        assert torch.equal(y_sub, y[..., rows, :, :])
    rng = np.random.default_rng(3)
    gys = [torch.tensor(rng.standard_normal(base.shape[:-1] + (4,)).astype(np.float32)) for _ in range(3)]
    a1s = [torch.clamp_min(base + tb1[:, s], 0.0) for s in range(3)]
    denc = k5.head_backward_plain(enc, w1[:-1], a1s, gys, ts, w2, tier)[0]
    denc_sub = k5.head_backward_plain(enc[rows], w1[:-1], [a[rows] for a in a1s], [gy[rows] for gy in gys], ts, w2,
                                      tier)[0]
    assert torch.equal(denc_sub, denc[rows])
