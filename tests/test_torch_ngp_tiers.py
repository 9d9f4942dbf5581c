"""The reduced-precision tiers of the encoded-field (NGP) path and K1's
bf16-I/O entry points, against the JAX package (Pallas in interpret mode),
and the routing repairs around them (tier tables, the NGP step's engine,
two JAX keywords).

Tolerances, and why:
- K5 / K7 bf16 where only the sum order differs from JAX: loss 1e-5
  relative, every gradient leaf 1e-3 relative L2. On the CPU, JAX runs
  Precision.DEFAULT as HIGHEST, so a product that the JAX kernel leaves to
  DEFAULT without an explicit cast (K5's forward base) is unrounded there;
  these cases feed bf16-representable encodings and W1 (Fourier, whose
  encode has no parameters, the JAX side's encode rounded), so the port's
  rounding of them is exact and the two differ by sum order alone. The
  gradients carry a bf16 rounding of intermediates (gy, a1, dz1) whose
  1-ulp flips under another sum order reach 1e-4 of a leaf.
- The whole bf16 step with the hash fast encode: JAX's bf16 class, 5e-2
  (its CPU backend runs the fast encode exactly; the port rounds), at
  dt = 0.25. At dt = 1e-2 the bf16 rounding of each slice's a1 (about
  4e-3) is as large as the slices' difference 2 dt W1[-1], so the tables'
  gradients (from dz1_sum, where the t -+ dt legs cancel) follow which way
  those roundings fall: two bf16 computations that round different
  operands (the port against JAX-on-CPU, whose forward base is unrounded,
  or the port's fast encode against its exact one) part there beyond the
  bf16 class, while the head's gradients stay within it.
- K5 f32_fastbwd: the loss is f32 K5's to the bit (within 1e-6 of JAX's),
  the gradients within 1e-3 of JAX's fastbwd and not equal to the f32
  tier's.
- The bf16 head (autograd path) against JAX generate_fields("bf16"):
  fields 1e-5 (the same rounding points; sum order). Gradients 1e-4, and
  1e-3 for W1 and W2: JAX's cast VJPs round the cotangents of a1 and of
  the encoding, and the gradients of W1[:-1] and W2, to bf16 (the
  cotangent meets the other rounded operand in float32, then the result is
  rounded: _MatmulBf16), so a sum-order difference flips an element's
  rounding by one bf16 ulp (2^-8 of it); W1's and W2's gradients are such
  elements themselves, the others sums of them (2.5e-5 seen for b1).
- The fast encode against a float64 referee that rounds the same operands:
  2e-6 relative L2 (float32 sums against float64 ones, and the rare bf16
  flip of an intermediate); Fourier's fast encode is its exact encode.
- K1 bf16 / mixed_out: outputs equal to JAX's or 1 bf16 ulp apart (the
  float32 residual before the rounding differs in its last bits), their
  VJPs 1e-5 relative L2.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.pallas import fit as jfit
from phys_autodiff_tpu.pallas import mega_ngp as jmega_ngp
from phys_autodiff_tpu.pallas import residuals as jres
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, PhysWeights
from phys_autodiff_tpu_torch.apps import transport as tr
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.models import encoders, mlp, ngp
from phys_autodiff_tpu_torch.models import hash_encoder as hash_enc
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.train import fit_field as ff
from phys_autodiff_tpu_torch.train.loop import TrainConfig, make_ngp_train_step, resolve_ngp_backward
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jfourier, jngp)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


HASH = HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                          dense_oversubscribed=True)
FOURIER = FourierEncodingConfig(num_frequencies=2)
W = PhysWeights(w_sigma=1.3, w_u=0.7)
T = 0.3


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _setup(encoding=HASH, nx=128, ny=8, nz=6, periodic=True, scheme="central", round_w1=False, hidden=16):
    """K5's grid and params (tests/test_torch_mega_ngp.py's setup); round_w1
    makes W1 bf16-representable."""
    g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.3, hy=0.3, hz=0.3, dt=1e-2, periodic=periodic, scheme=scheme)
    cfg = ngp.NGPFieldConfig(encoding=encoding, hidden=hidden)
    jp = jngp.init_ngp_params(_jax(cfg), seed=7)
    rng = np.random.Generator(np.random.MT19937(21))
    jp["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jp["tables"])
    jp["b1"] = jnp.asarray(rng.standard_normal(jp["b1"].shape) * 0.3, jnp.float32)
    jp["b2"] = jnp.asarray(rng.standard_normal(jp["b2"].shape) * 0.3, jnp.float32)
    if round_w1:
        jp["W1"] = jnp.asarray(_bf16_np(jp["W1"]))
    return g, cfg, jp, ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _agree(port, ref, loss_tol, grad_tol):
    (loss, (gp, _)), (loss_ref, (gp_ref, _)) = port, ref
    assert abs(float(loss) - float(loss_ref)) <= loss_tol * abs(float(loss_ref))
    ref_leaves = jax.tree_util.tree_leaves_with_path(gp_ref)
    port_leaves = tree.leaves(gp)
    assert len(port_leaves) == len(ref_leaves)
    for (key, b), a in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == b.shape, jax.tree_util.keystr(key)
        if b.size:
            assert _rel(a.detach().numpy(), b) <= grad_tol, (jax.tree_util.keystr(key), _rel(a.detach().numpy(), b))


@pytest.fixture
def jax_encode_rounded(monkeypatch):
    """The JAX kernels' caller with its encode rounded to bf16 (a
    parameter-free encoding only: no pull-back runs)."""
    orig = jmega_ngp.encode_grid_zcf
    monkeypatch.setattr(jmega_ngp, "encode_grid_zcf",
                        lambda cfg, tb, g, fast=False: jnp.asarray(_bf16_np(orig(cfg, tb, g, fast=fast))))


def _jax_k5(g, cfg, jp, precision):
    return jmega_ngp.ngp_loss_and_grad(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(T), precision, interpret=True)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_k5_bf16_matches_jax_kernel_up_to_sum_order(jax_encode_rounded, periodic, scheme):
    g, cfg, jp, tp = _setup(FOURIER, periodic=periodic, scheme=scheme, round_w1=True)
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, T, "bf16")
    _agree(port, _jax_k5(g, cfg, jp, "bf16"), 1e-5, 1e-3)
    f32 = k5.ngp_loss_and_grad(g, W, cfg, tp, T)
    assert not torch.equal(port[1][0]["W2"], f32[1][0]["W2"])


def test_k5_bf16_step_with_the_hash_fast_encode_is_in_the_bf16_class():
    g, cfg, jp, tp = _setup(HASH)
    g = dataclasses.replace(g, dt=0.25)  # see the module docstring
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, T, "bf16")
    _agree(port, _jax_k5(g, cfg, jp, "bf16"), 5e-2, 5e-2)
    # the tables' gradient came through the fast encode's pull-back
    exact = k5.ngp_loss_and_grad(g, W, cfg, tp, T, "f32")
    assert not torch.equal(tree.leaves(port[1][0]["tables"])[0], tree.leaves(exact[1][0]["tables"])[0])


@pytest.mark.parametrize("encoding", [HASH, FOURIER], ids=["hash", "fourier"])
def test_k5_f32_fastbwd_keeps_the_f32_loss_and_rounds_the_backward(encoding):
    g, cfg, jp, tp = _setup(encoding)
    port = k5.ngp_loss_and_grad(g, W, cfg, tp, T, "f32_fastbwd")
    f32 = k5.ngp_loss_and_grad(g, W, cfg, tp, T, "f32")
    assert torch.equal(port[0], f32[0])
    _agree(port, _jax_k5(g, cfg, jp, "f32_fastbwd"), 1e-6, 1e-3)
    assert not torch.equal(port[1][0]["W1"], f32[1][0]["W1"])
    assert not torch.equal(port[1][0]["W2"], f32[1][0]["W2"])


@pytest.mark.parametrize("tier", ["bf16", "f32_fastbwd"])
def test_k5_tier_head_matches_its_explicit_rounding(tier):
    """The plain head of a tier against the same function spelled out in
    float64 on the tier's rounded operands (same masks): what the kernel is
    held to on the card. Its loss is the fixed-order sum of the plane
    partials (ops_loss.sum_partials) of the tier's fields, so it is held to
    the same route on the same fields, bit for bit; loss_forward's single
    float32 sum over the grid adds in another order."""
    g, cfg, _, tp = _setup(HASH, nz=3)
    ts = torch.tensor([T - g.dt, T, T + g.dt], dtype=torch.float32)
    enc = encoders.encode_grid_zcf(cfg.encoding, tp["tables"], g, fast=tier == "bf16")
    args = (enc, tp["W1"], tp["b1"], tp["W2"], tp["b2"], ts)
    loss, (denc, dw1, db1, dw2, db2) = k5.head_loss_and_grad(g, W, *args, tier)
    assert all(torch.isfinite(x).all() for x in (loss, denc, dw1, db1, dw2, db2))
    # the loss of the tier's fields, through the staged f32 pipeline
    w1, b1, w2, b2 = tp["W1"], tp["b1"], tp["W2"], tp["b2"]
    base = k5._base(enc, w1, "bf16" if tier == "bf16" else "f32")
    fs = k5._head_from_base(base, k5.first_layer_bias(w1, b1, ts), w2, b2, arithmetic=tier)
    parts = ops_loss.plane_partials(*ops_stencil.residuals(g, fs))
    assert torch.equal(loss, torch.stack(ops_loss.sum_partials(g, W, parts)))
    with pytest.raises(ValueError, match="referee holds the f32 tier"):
        k5.head_loss_and_grad_ref(g, W, *args, tier)


def _split3(x):
    """csrc/mega_ngp.cu split3 in numpy: float32 x as hi + mid + lo, each
    the top 8 significant bits (a bf16 value) of what is left, truncated."""
    hi = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    r1 = (x - hi).astype(np.float32)
    mid = (r1.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    r2 = (r1 - mid).astype(np.float32)
    return hi, mid, (r2.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def test_the_three_way_bf16_split_of_dz1_is_exact():
    """The premise of K5 f32_fastbwd's dW1 on the tensor cores
    (csrc/mega_ngp.cu split3, dw1_rows_split): every finite float32 of
    magnitude 2^-110 or more, up to the float32 maximum, is the exact sum
    of three bf16 values (its 24 significant bits in three runs of 8, cut
    by truncation, so no part rounds past the float32 range); a bf16
    encoding value times a part is exact in float32 (8 x 8 significant
    bits); so the float64 sum of bf16(enc) times the three parts is the
    float64 product bf16(enc) . dz1, and the tensor cores' float32
    accumulation is the only difference from FFMA. Below 2^-110
    (subnormals included) the bits under the least bf16 subnormal, 2^-133,
    drop: less than 2^-133 a value."""
    rng = np.random.default_rng(13)
    n = 4096
    big = rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-110, 128, n)
    fmax = np.finfo(np.float32).max
    x = np.concatenate([big, [fmax, -fmax, 0.0, 2.0 ** -110, 1.0 + 2.0 ** -23]]).astype(np.float32)
    parts = _split3(x)
    for part in parts:
        assert np.all(np.isfinite(part)) and not np.any(part.view(np.uint32) & np.uint32(0xFFFF))
    assert np.array_equal(parts[0].astype(np.float64) + parts[1] + parts[2], x.astype(np.float64))
    sub = rng.integers(1, 2 ** 23, 256).astype(np.uint32).view(np.float32)  # float32 subnormals
    tiny = (rng.uniform(1.0, 2.0, 256) * 2.0 ** rng.integers(-126, -110, 256)).astype(np.float32)
    for small in (sub, tiny):
        lost = np.abs(sum(p.astype(np.float64) for p in _split3(small)) - small.astype(np.float64))
        assert lost.max() < 2.0 ** -133
    # the products: dz1 as the kernel meets it (2^-40 .. 2^40), a bf16 encoding
    dz1 = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).astype(np.float32)
    enc = _bf16_np(rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n))
    hi, mid, lo = _split3(dz1)
    for part in (hi, mid, lo):
        assert np.array_equal((enc * part).astype(np.float64), enc.astype(np.float64) * part.astype(np.float64))
    e64 = enc.astype(np.float64)
    assert math.fsum(np.concatenate([e64 * hi, e64 * mid, e64 * lo])) == math.fsum(e64 * dz1.astype(np.float64))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _fit_case(encoding, round_w1):
    g = GridSpec(nx=16, ny=8, nz=6, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
    cfg = ngp.NGPFieldConfig(encoding=encoding, hidden=16)
    jp = jngp.init_ngp_params(_jax(cfg), seed=5)
    if round_w1:
        jp["W1"] = jnp.asarray(_bf16_np(jp["W1"]))
    tp = ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    target = kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u))
    jtarget = jfit.pack_target(_jax(g), jnp.asarray(sigma), jnp.asarray(u))
    return g, cfg, jp, tp, target, jtarget


def test_k7_bf16_matches_jax_kernel_up_to_sum_order():
    """K7's JAX kernel casts every operand itself, so Fourier (no fast
    encode) differs by sum order alone."""
    g, cfg, jp, tp, target, jtarget = _fit_case(FOURIER, round_w1=False)
    port = kfit.ngp_fit_loss_and_grad(g, cfg, tp, target, T, W, "bf16")
    ref = jfit.ngp_fit_loss_and_grad(_jax(g), _jax(cfg), jp, jtarget, T, _jax(W), "bf16", True)
    _agree(port, ref, 1e-5, 1e-3)
    f32 = kfit.ngp_fit_loss_and_grad(g, cfg, tp, target, T, W)
    assert not torch.equal(port[1][0]["W2"], f32[1][0]["W2"])


def test_k7_bf16_step_with_the_hash_fast_encode_is_in_the_bf16_class():
    """The data loss has no time difference: the bf16 class at any dt."""
    g, cfg, jp, tp, target, jtarget = _fit_case(HASH, round_w1=False)
    port = kfit.ngp_fit_loss_and_grad(g, cfg, tp, target, T, W, "bf16")
    ref = jfit.ngp_fit_loss_and_grad(_jax(g), _jax(cfg), jp, jtarget, T, _jax(W), "bf16", True)
    _agree(port, ref, 5e-2, 5e-2)


# ---------------------------------------------------------------------------
# The bf16 head (the autograd path) and the fast encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["snapshots", "packed"])
@pytest.mark.parametrize("encoding", [HASH, FOURIER], ids=["hash", "fourier"])
def test_bf16_head_matches_jax_generate_fields(encoding, packed):
    g, cfg, jp, tp = _setup(encoding, nx=16, nz=5)
    wts = np.random.default_rng(3).standard_normal((12,) + g.shape).astype(np.float32)

    if packed:
        def jfn(p):
            return jngp.generate_fields_packed(_jax(g), _jax(cfg), p, T, g.dt, "bf16")

        def pfn(p):
            return ngp.generate_fields_packed(g, cfg, p, T, g.dt, "bf16")
    else:
        def jfn(p):
            f = jngp.generate_fields(_jax(g), _jax(cfg), p, T, g.dt, "bf16")
            return jnp.concatenate([f.sigma_tm1[None], f.sigma_t[None], f.sigma_tp1[None], f.u_tm1, f.u_t, f.u_tp1])

        def pfn(p):
            f = ngp.generate_fields(g, cfg, p, T, g.dt, "bf16")
            return torch.cat([f.sigma_tm1[None], f.sigma_t[None], f.sigma_tp1[None], f.u_tm1, f.u_t, f.u_tp1])

    jy, jvjp = jax.vjp(jfn, jp)
    (jg,) = jvjp(jnp.asarray(wts))
    p = tree.map_tree(lambda x: x.detach().requires_grad_(), tp)
    y = pfn(p)
    assert _rel(y.detach().numpy(), jy) <= 1e-5
    leaves = tree.leaves(p)
    grads = torch.autograd.grad((y * torch.tensor(wts)).sum(), leaves, allow_unused=True)
    for (key, b), a, x in zip(jax.tree_util.tree_leaves_with_path(jg), grads, leaves):
        a = torch.zeros_like(x) if a is None else a
        name = jax.tree_util.keystr(key)
        if b.size:
            assert _rel(a.numpy(), b) <= (1e-3 if name in ("['W1']", "['W2']") else 1e-4), name
    exact = ngp.generate_fields_packed(g, cfg, tp, T, g.dt)
    assert not torch.equal(ngp.generate_fields_packed(g, cfg, tp, T, g.dt, "bf16"), exact)


def _resample64(grid, n, r, axis, bf):
    m = hash_enc._resample_matrix(n, r).astype(np.float64)
    x = grid.astype(np.float64)
    if bf:
        m, x = _bf16_np(m).astype(np.float64), _bf16_np(grid).astype(np.float64)
    return np.moveaxis(np.tensordot(x, m, axes=([axis], [0])), -1, axis)


def test_fast_encode_matches_a_float64_referee_and_fourier_falls_back_exactly():
    g = GridSpec(nx=11, ny=7, nz=5)
    cfg = HASH
    tables = tree.map_tree(lambda x: x * 2000.0, encoders.init_params(cfg, seed=3, device="cpu"))
    tab = tree.map_tree(lambda x: x.detach().requires_grad_(), tables)
    fast = encoders.encode_grid_zcf(cfg, tab, g, fast=True)
    exact = encoders.encode_grid_zcf(cfg, tables, g)
    hash_tables, dense = hash_enc._tables_view(cfg, tab)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    levels = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = torch.movedim(dense[lvl], -1, 1)
        else:
            corner = torch.movedim(hash_enc._hashed_corners(cfg, hash_tables[hash_pos[lvl]], r), -1, 1)
        lev = corner.detach().numpy()
        for n, axis in ((g.nz, 0), (g.ny, 2), (g.nx, 3)):
            lev = _resample64(lev, n, r, axis, True).astype(np.float32)
        levels.append(lev)
    ref = np.concatenate(levels, axis=1)
    assert _rel(fast.detach().numpy(), ref) <= 2e-6
    assert 1e-5 < _rel(fast.detach().numpy(), exact.numpy()) <= 5e-2
    # the pull-back reaches every table through the rounded transposed resamples
    cot = torch.tensor(np.random.default_rng(4).standard_normal(fast.shape).astype(np.float32))
    grads = torch.autograd.grad(fast, tree.leaves(tab), cot)
    grads_exact = torch.autograd.grad(encoders.encode_grid_zcf(cfg, tab, g), tree.leaves(tab), cot)
    for a, b in zip(grads, grads_exact):
        assert 0 < _rel(a.numpy(), b.numpy()) <= 5e-2
    # one level's three resamples, forward and pull-back, against the referee
    r = 6
    corner = torch.tensor(np.random.default_rng(5).standard_normal((r + 1, 2, r + 1, r + 1)).astype(np.float32),
                          requires_grad=True)
    lev, ref = corner, corner.detach().numpy()
    for n, axis in ((g.nz, 0), (g.ny, 2), (g.nx, 3)):
        lev = hash_enc._axis_lerp_dense(lev, n, r, axis, fast=True)
        ref = _resample64(ref, n, r, axis, True).astype(np.float32)
    assert _rel(lev.detach().numpy(), ref) <= 2e-6
    cot = np.random.default_rng(6).standard_normal(lev.shape).astype(np.float32)
    (d,) = torch.autograd.grad(lev, corner, torch.tensor(cot))
    ref = cot
    for n, axis in ((g.nx, 3), (g.ny, 2), (g.nz, 0)):
        m = _bf16_np(hash_enc._resample_matrix(n, r)).astype(np.float64)
        ref = np.moveaxis(np.tensordot(_bf16_np(ref).astype(np.float64), m, axes=([axis], [1])), -1, axis)
        ref = ref.astype(np.float32)
    assert _rel(d.numpy(), ref) <= 2e-6
    # Fourier registers no fast encode: the exact one, bit for bit
    fcfg = FOURIER
    empty = encoders.init_params(fcfg, device="cpu")
    assert torch.equal(encoders.encode_grid_zcf(fcfg, empty, g, fast=True), encoders.encode_grid_zcf(fcfg, empty, g))


# ---------------------------------------------------------------------------
# K1's bf16-I/O entry points
# ---------------------------------------------------------------------------


def _ulp_close(a, b):
    """bf16 arrays equal or one bf16 ulp apart, elementwise."""
    a = np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)).view(np.uint16).astype(np.int32)
    b = np.asarray(jnp.asarray(b, jnp.float32).astype(jnp.bfloat16)).view(np.uint16).astype(np.int32)
    return int(np.abs(a - b).max()) <= 1


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("kind", ["bf16", "mixed_out"])
def test_k1_bf16_entry_points_match_jax(kind, periodic, scheme):
    g = GridSpec(nx=128, ny=6, nz=4, hx=0.3, hy=0.4, hz=0.5, dt=1e-2, periodic=periodic, scheme=scheme)
    rng = np.random.default_rng(11)
    packed = rng.standard_normal((12,) + g.shape).astype(np.float32)
    cot = rng.standard_normal((4,) + g.shape).astype(np.float32)
    if kind == "bf16":
        jin, tin = jnp.asarray(packed).astype(jnp.bfloat16), torch.tensor(packed).to(torch.bfloat16)
        jfn, pfn = jres.residuals_fused_packed_bf16, kres.residuals_fused_packed_bf16
    else:
        jin, tin = jnp.asarray(packed), torch.tensor(packed)
        jfn, pfn = jres.residuals_fused_packed_mixed_out, kres.residuals_fused_packed_mixed_out
    jy, jvjp = jax.vjp(lambda p: jfn(_jax(g), p, True), jin)
    (jd,) = jvjp(jnp.asarray(cot).astype(jnp.bfloat16))
    x = tin.detach().requires_grad_()
    y = pfn(g, x)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (4,) + g.shape
    assert _ulp_close(y.float().detach().numpy(), np.asarray(jy, np.float32))
    (d,) = torch.autograd.grad(y, x, torch.tensor(cot).to(torch.bfloat16))
    assert d.dtype == tin.dtype
    assert _rel(d.float().numpy(), np.asarray(jd, np.float32)) <= 1e-5


def test_k1_f32_wrappers_given_bf16_name_the_entry_points():
    g = GridSpec(nx=8, ny=4, nz=3)
    with pytest.raises(ValueError, match="residuals_fused_packed_bf16.*residuals_fused_packed_mixed_out"):
        kres.residuals_fused_packed(g, torch.zeros((12,) + g.shape), "bf16")
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        kres.residuals_fused_packed_bf16(g, torch.zeros((12,) + g.shape))
    with pytest.raises(TypeError, match="must be torch.float32"):
        kres.residuals_fused_packed_mixed_out(g, torch.zeros((12,) + g.shape, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# F9: the tier tables; F10: the NGP step's engine; F11: JAX keywords
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32_high", "bf16x3", "f32_fastbwd"])
def test_routed_tiers_run_float32_to_the_bit(precision):
    """Every f32 name of the JAX package is the f32 arithmetic in the head
    and K7, and in K5 but for f32_fastbwd (models/ngp.py, pallas/fit.py,
    pallas/mega_ngp.py of the JAX package)."""
    g, cfg, _, tp = _setup(HASH, nx=16, nz=4)
    assert torch.equal(ngp.generate_fields_packed(g, cfg, tp, T, g.dt, precision),
                       ngp.generate_fields_packed(g, cfg, tp, T, g.dt))
    rng = np.random.default_rng(0)
    target = kfit.pack_target(g, torch.tensor(rng.normal(size=g.shape).astype(np.float32)),
                              torch.tensor(rng.normal(size=(3,) + g.shape).astype(np.float32)))
    a = kfit.ngp_fit_loss_and_grad(g, cfg, tp, target, T, W, precision)
    b = kfit.ngp_fit_loss_and_grad(g, cfg, tp, target, T, W)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(tree.leaves(a[1][0]), tree.leaves(b[1][0])))
    a = k5.ngp_loss_and_grad(g, W, cfg, tp, T, precision)
    b = k5.ngp_loss_and_grad(g, W, cfg, tp, T)
    same = all(torch.equal(x, y) for x, y in zip(tree.leaves(a[1][0]), tree.leaves(b[1][0])))
    assert torch.equal(a[0], b[0]) and same == (precision != "f32_fastbwd")
    assert ngp.check_precision(precision, "K7") == "f32"
    with pytest.raises(ValueError, match="unknown precision"):
        ngp.check_precision("tf32", "K5")


def test_fit_engine_reads_the_ngp_tier_through_k7():
    """On the card, "auto" with f32_high outside K7's gate falls to xla as
    f32 does; bf16 raises naming the gate of its tier."""
    g = GridSpec(nx=16, ny=8, nz=4)
    wide = ngp.NGPFieldConfig(encoding=HASH, hidden=300)
    for precision in ("f32", "f32_high", "bf16x3", "f32_fastbwd"):
        assert ff._resolve_fit_engine("auto", g, wide, 0.0, on_card=True, precision=precision) == "xla"
    with pytest.raises(ValueError, match=r"K7 \(bf16\) H <= \d+"):
        ff._resolve_fit_engine("auto", g, wide, 0.0, on_card=True, precision="bf16")
    with pytest.raises(ValueError, match=r"K5 \(bf16\) H <= \d+"):
        ff._resolve_fit_engine("auto", g, wide, 0.1, on_card=True, precision="bf16")
    small = ngp.NGPFieldConfig(encoding=HASH, hidden=64)
    assert ff._resolve_fit_engine("auto", g, small, 0.1, on_card=True, precision="bf16") == "mega"


@pytest.mark.parametrize("precision", ["f32", "bf16", "f32_fastbwd"])
def test_ngp_step_backward_resolution(precision):
    """resolve_ngp_backward with an on-card flag: "auto" takes K5 only
    within its gate (the F10 cases: Fourier with 11 frequencies, LF = 69;
    H = 256), else xla; an explicit "mega" outside the gate raises; CPU
    params resolve as before (K5's plain version wherever the grid is
    supported)."""
    g = GridSpec(nx=16, ny=8, nz=4)
    flagship = ngp.NGPFieldConfig()
    lf69 = ngp.NGPFieldConfig(encoding=FourierEncodingConfig(num_frequencies=11))
    h256 = ngp.NGPFieldConfig(hidden=256)
    assert lf69.encoding.out_dim == 69
    assert resolve_ngp_backward("auto", g, flagship, precision, on_card=True) == "mega"
    for cfg in (lf69, h256):
        assert resolve_ngp_backward("auto", g, cfg, precision, on_card=True) == "xla"
        with pytest.raises(ValueError, match="K5"):
            resolve_ngp_backward("mega", g, cfg, precision, on_card=True)
        assert resolve_ngp_backward("auto", g, cfg, precision, on_card=False) == "mega"
        assert resolve_ngp_backward("xla", g, cfg, precision, on_card=True) == "xla"
    with pytest.raises(ValueError, match="unknown backward"):
        resolve_ngp_backward("fast", g, flagship, precision)


@pytest.mark.parametrize("backward", ["mega", "xla"])
def test_bf16_ngp_training_steps_run_their_tier(backward):
    g, cfg, _, tp = _setup(HASH, nx=16, nz=4)
    tcfg = TrainConfig(learning_rate=1e-3, seed=0)
    losses = {}
    for precision in ("f32", "bf16"):
        step, state = make_ngp_train_step(g, W, cfg, tcfg, tp, precision, backward=backward)
        for _ in range(2):
            state, loss = step(state)
        losses[precision] = (float(loss), state.params["W2"].clone())
    assert np.isfinite(losses["bf16"][0])
    assert abs(losses["bf16"][0] - losses["f32"][0]) <= 5e-2 * abs(losses["f32"][0])
    assert not torch.equal(losses["bf16"][1], losses["f32"][1])


def test_jax_keywords_check_cfl_and_init_dtype():
    cfg = tr.TransportConfig(check_cfl=False, steps=2)
    assert cfg.check_cfl is False and tr.TransportConfig().check_cfl is True
    dims = MLPDims(H=8)
    p16 = mlp.init_params(dims, seed=3, device="cpu", dtype=torch.bfloat16)
    j16 = jmlp.init_params(jconfig.MLPDims(H=8), seed=3, dtype=jnp.bfloat16)
    p32 = mlp.init_params(dims, seed=3, device="cpu")
    for k in p32:
        assert p16[k].dtype == torch.bfloat16
        assert torch.equal(p16[k], p32[k].to(torch.bfloat16))
        np.testing.assert_array_equal(p16[k].float().numpy(), np.asarray(j16[k], np.float32))
