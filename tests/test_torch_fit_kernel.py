"""K6 and K7, the supervised-fit kernels (phys_autodiff_tpu_torch/kernels/fit.py),
vs the JAX kernels (pallas/fit.py, interpret mode) and jax.value_and_grad of
the JAX staged data loss (train.fit_field.data_loss).

On the CPU the port runs the kernels' plain versions: float32 autograd
through the table MLP or the NGP head and the fixed-order data loss, with
the folds' and the encoder's pull-backs by autograd. Tolerances are those
of tests/test_fit_kernel.py:62-68 and :257-263: loss 1e-6 relative, every
gradient leaf 2e-5 relative (atol 1e-7), d_t 1e-4. The JAX kernels take
only lane-aligned planes (ny * nx % 128 == 0); the ragged grids are held to
jax.grad of the data loss alone.
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
from phys_autodiff_tpu.pallas import fit as jfit
from phys_autodiff_tpu.pallas.mega_bwd import _resolve_mode
from phys_autodiff_tpu.pallas.mlp import fold_ab_plane as jfold_ab_plane, fold_cd as jfold_cd
from phys_autodiff_tpu.train import fit_field as jff
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.models import encoders, mlp, ngp
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.utils import tree

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


W = PhysWeights(w_sigma=1.3, w_u=0.6)


def _grid(nx=16, ny=8, nz=6, periodic=True):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.2, hy=0.2, hz=0.2, dt=1e-3, periodic=periodic)


def _target(g, seed=0, t=0.3):
    rng = np.random.default_rng(seed)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    return sigma, u, t


def _jax_data_value_and_grad(g, cfg, tgt, w):
    sigma, u, _ = tgt

    def loss_fn(p, tt):
        return jff.data_loss(_jax(g), _jax(cfg), p, jff.FitTarget(jnp.asarray(sigma), jnp.asarray(u), tt), _jax(w))

    return jax.value_and_grad(loss_fn, argnums=(0, 1))


def _jax_data_loss_and_grad(g, cfg, jp, tgt, w):
    return _jax_data_value_and_grad(g, cfg, tgt, w)(jp, jnp.float32(tgt[2]))


def _agree(port, ref, leaf_tol=2e-5, dt_tol=1e-4):
    """port (loss, (grads, d_t)) against a JAX (loss, (grads, d_t)), leaf by
    leaf in jax.tree_util order (W2 in its own [H, 4] layout on both)."""
    (loss, (gp, d_t)), (loss_ref, (gp_ref, d_t_ref)) = port, ref
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    ref_leaves = jax.tree_util.tree_leaves_with_path(gp_ref)
    port_leaves = tree.leaves(gp)
    assert len(port_leaves) == len(ref_leaves)
    for (key, b), a in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == b.shape, jax.tree_util.keystr(key)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=leaf_tol, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(key))
    if d_t_ref is not None:
        np.testing.assert_allclose(float(d_t), float(d_t_ref), rtol=dt_tol, atol=1e-7)


def _mlp_setup(g, h=8, seed=1):
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    jp = jff.init_any(_jax(cfg), seed=seed)
    return cfg, jp, mlp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 8, 6), (12, 32, 5), (16, 8, 1)], ids=["aligned", "flatM", "nz1"])
def test_fit_loss_and_grad_matches_jax_kernel_and_grad(shape):
    g = _grid(*shape)
    cfg, jp, tp = _mlp_setup(g)
    sigma, u, t = tgt = _target(g)
    port = kfit.fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree(port, _jax_data_loss_and_grad(g, cfg, jp, tgt, W))
    packed = jfit.pack_target(_jax(g), sigma, u)
    _agree(port, jfit.fit_loss_and_grad(_jax(g), _jax(cfg), jp, packed, t, _jax(W), interpret=True))


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("shape", [(24, 13, 5), (7, 3, 11)], ids=["24x13x5", "7x3x11"])
def test_fit_loss_and_grad_on_ragged_grids_matches_jax_grad(shape, periodic):
    """Planes the JAX kernel refuses (ny * nx % 128 != 0): the port's gate
    takes them; held to jax.grad of the data loss."""
    g = _grid(*shape, periodic=periodic)
    assert kfit.fit_supported(g) and not jfit.fit_supported(_jax(g))
    cfg, jp, tp = _mlp_setup(g, h=16, seed=4)
    sigma, u, t = tgt = _target(g, seed=2)
    port = kfit.fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree(port, _jax_data_loss_and_grad(g, cfg, jp, tgt, W))


# The edges of the tiled MLP core that chip_smoke.py holds K6 to on the card
# (its mlp_edges), all small: H 4, 33, 100, 200, 512 and the gate's top 1724;
# 33x9x150, 600 tile rows for 264 blocks; nx 7, 24, 33, 40 with ragged ny;
# nz 1, 2, 5, 9, 17. The plain version is the referee there; here it is held
# to jax.grad of the JAX data loss (no plane here is lane-aligned, so the
# JAX kernel refuses them all), and on a lane-aligned 16x8x9 grid to the JAX
# kernel in interpret mode as well, at the contract chip_smoke.py holds K6
# to: loss 1e-6 relative, every gradient leaf 2e-5 in relative L2, d_t 1e-4.
# (Element by element, a few near-zero entries of the wider and larger cases
# differ by 2e-7 to 1e-6 between the two float32 summation orders.)
FIT_EDGES = [((40, 9, 1), 4), ((7, 3, 9), 33), ((24, 13, 17), 100), ((33, 10, 2), 200), ((40, 9, 5), 512),
             ((33, 9, 150), 128), ((24, 5, 3), 1724), ((7, 3, 2), 1724)]


def _agree_l2(port, ref):
    (loss, (gp, d_t)), (loss_ref, (gp_ref, d_t_ref)) = port, ref
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    ref_leaves = jax.tree_util.tree_leaves_with_path(gp_ref)
    for (key, b), a in zip(ref_leaves, tree.leaves(gp), strict=True):
        a, b = a.detach().numpy().astype(np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape and np.linalg.norm(a - b) <= 2e-5 * np.linalg.norm(b), jax.tree_util.keystr(key)
    np.testing.assert_allclose(float(d_t), float(d_t_ref), rtol=1e-4, atol=1e-7)


def _jax_data_loss_and_grad_jit(g, cfg, jp, tgt, w):
    """_jax_data_loss_and_grad compiled once (eager JAX compiles every op)."""
    return jax.jit(_jax_data_value_and_grad(g, cfg, tgt, w))(jp, jnp.float32(tgt[2]))


@pytest.mark.parametrize("dims, h", FIT_EDGES, ids=[f"{d[0]}x{d[1]}x{d[2]}-H{h}" for d, h in FIT_EDGES])
def test_fit_plain_version_at_the_core_edges_matches_jax_grad(dims, h):
    g = _grid(*dims, periodic=dims[2] % 2 == 0)
    cfg, jp, tp = _mlp_setup(g, h=h, seed=5)
    sigma, u, t = tgt = _target(g, seed=6)
    port = kfit.fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree_l2(port, _jax_data_loss_and_grad_jit(g, cfg, jp, tgt, W))


def test_fit_plain_version_on_an_aligned_edge_matches_jax_kernel():
    g = _grid(16, 8, 9)
    cfg, jp, tp = _mlp_setup(g, h=33, seed=5)
    sigma, u, t = tgt = _target(g, seed=6)
    port = kfit.fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree_l2(port, _jax_data_loss_and_grad_jit(g, cfg, jp, tgt, W))
    packed = jfit.pack_target(_jax(g), sigma, u)
    _agree_l2(port, jfit.fit_loss_and_grad(_jax(g), _jax(cfg), jp, packed, t, _jax(W), interpret=True))


def test_fit_tables_match_the_jax_kernel_outputs():
    """The table-level outputs (loss, dAB, dCD, dW2T, db2) against the JAX
    kernel's raw outputs; its dW2 comes out [H, 4] in the vpu arm and is
    transposed to the port's W2T layout [4, H]."""
    g = _grid(16, 8, 6)
    cfg, jp, tp = _mlp_setup(g, h=16, seed=3)
    sigma, u, t = _target(g, seed=5)
    jg, h, m = _jax(g), 16, g.ny * g.nx
    abf = jfold_ab_plane(jg, _jax(cfg), jp).reshape(h, m)
    cd = jfold_cd(jg, _jax(cfg), jp, jnp.stack([jnp.float32(t)]))
    w2t = jp["W2"].T
    call = jfit._build_fit_call(jg, h, _jax(W), "f32", True)
    parts, dabf, dcdx, dw2g, db2x = call(abf, cd, w2t, w2t.T, jp["b2"].reshape(1, -1), jfit.pack_target(jg, sigma, u))
    if _resolve_mode("dw2", "f32") != "dot":
        dw2g = dw2g.T
    tables = kmlp.fold_tables(g, cfg, tp, torch.tensor([t], dtype=torch.float32))
    loss, grads = kfit.fit_table_loss_and_grad(g, W, *tables, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)))
    ls, lu = jax.numpy.asarray(parts).sum(axis=1) * np.float32(1.0 / g.num_cells) * np.array([W.w_sigma, W.w_u])
    np.testing.assert_allclose(loss.numpy(), [ls, lu], rtol=1e-6)
    for a, b in zip(grads, (dabf.reshape(h, g.ny, g.nx), dcdx[..., :1], dw2g, db2x[:, 0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-7)


def test_pack_target_matches_jax():
    g = _grid(nx=4, ny=3, nz=2)
    sigma = np.arange(g.num_cells, dtype=np.float32).reshape(g.shape)
    u = np.stack([sigma + 100, sigma + 200, sigma + 300])
    packed = kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u))
    assert tuple(packed.shape) == (g.nz, 4, g.ny * g.nx) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jfit.pack_target(_jax(g), sigma, u)))
    np.testing.assert_array_equal(kfit.pack_target(g, sigma, u).numpy(), packed.numpy())


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

MIXED = HashEncodingConfig(num_levels=3, log2_table_size=6, base_resolution=3, max_resolution=8,
                           dense_oversubscribed=True)
HASH_ONLY = HashEncodingConfig(num_levels=3, log2_table_size=6, base_resolution=3, max_resolution=8,
                               dense_oversubscribed=False)
FOURIER = FourierEncodingConfig(num_frequencies=3)


def _ngp_setup(encoding, seed=5):
    cfg = ngp.NGPFieldConfig(encoding=encoding, hidden=16)
    jp = jff.init_any(_jax(cfg), seed=seed)
    return cfg, jp, ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("encoding", [MIXED, HASH_ONLY, FOURIER], ids=["dense+hashed", "hash-only", "fourier"])
def test_ngp_fit_loss_and_grad_matches_jax_kernel_and_grad(encoding):
    g = _grid(16, 8, 6)
    cfg, jp, tp = _ngp_setup(encoding)
    sigma, u, t = tgt = _target(g, seed=6)
    port = kfit.ngp_fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree(port, _jax_data_loss_and_grad(g, cfg, jp, tgt, W))
    packed = jfit.pack_target(_jax(g), sigma, u)
    _agree(port, jfit.ngp_fit_loss_and_grad(_jax(g), _jax(cfg), jp, packed, t, _jax(W), interpret=True))


@pytest.mark.parametrize("encoding", [MIXED, FOURIER], ids=["dense+hashed", "fourier"])
@pytest.mark.parametrize("shape", [(24, 13, 5), (16, 8, 1)], ids=["ragged", "nz1"])
def test_ngp_fit_loss_and_grad_matches_jax_grad(shape, encoding):
    g = _grid(*shape, periodic=False)
    cfg, jp, tp = _ngp_setup(encoding, seed=7)
    sigma, u, t = tgt = _target(g, seed=8)
    port = kfit.ngp_fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, torch.tensor(sigma), torch.tensor(u)), t, W)
    _agree(port, _jax_data_loss_and_grad(g, cfg, jp, tgt, W))


def test_fourier_fit_needs_no_encoding_cotangent(monkeypatch):
    """A parameter-free encoding: the head takes need_denc=False and the
    empty tables get an empty zero gradient."""
    g = _grid(16, 8, 5)
    cfg, _, tp = _ngp_setup(FOURIER)
    sigma, u, t = _target(g)
    seen = []
    head = kfit.ngp_fit_head_loss_and_grad

    def spy(*args, need_denc=True):
        seen.append(need_denc)
        return head(*args, need_denc=need_denc)

    monkeypatch.setattr(kfit, "ngp_fit_head_loss_and_grad", spy)
    _, (gp, _) = kfit.ngp_fit_loss_and_grad(g, cfg, tp, kfit.pack_target(g, sigma, u), t)
    assert seen == [False]
    assert tuple(gp["tables"].shape) == (0,) and gp["tables"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The referees, the gates and the CPU dispatch
# ---------------------------------------------------------------------------


def test_referees_agree_with_the_plain_versions():
    """The float64 referees (the float32 forward's values and masks, the
    backward in float64) round to the float32 plain versions within 1e-5
    at a small grid, and return float32."""
    g = _grid(24, 13, 5)
    cfg, _, tp = _mlp_setup(g, h=16, seed=9)
    sigma, u, t = _target(g, seed=9)
    target = kfit.pack_target(g, sigma, u)
    tables = kmlp.fold_tables(g, cfg, tp, torch.tensor([t], dtype=torch.float32))
    for a, b in zip(*(fn(g, W, *tables, target) for fn in (kfit.fit_table_loss_and_grad_ref,
                                                              kfit.fit_table_loss_and_grad_plain))):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == torch.float32
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-9)
    ncfg, _, ntp = _ngp_setup(MIXED)
    enc = encoders.encode_grid_zcf(ncfg.encoding, ntp["tables"], g)
    args = (enc, ntp["W1"], ntp["b1"], ntp["W2"], ntp["b2"], torch.tensor(t, dtype=torch.float32), target)
    ref = kfit.ngp_fit_head_loss_and_grad_ref(g, W, *args)
    plain = kfit.ngp_fit_head_loss_and_grad_plain(g, W, *args)
    np.testing.assert_allclose(ref[0].numpy(), plain[0].numpy(), rtol=1e-5)
    for x, y in zip(ref[1], plain[1]):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-9)


def test_ngp_head_w1_time_row_is_t_db1():
    g = _grid(16, 8, 3)
    ncfg, _, ntp = _ngp_setup(MIXED)
    enc = encoders.encode_grid_zcf(ncfg.encoding, ntp["tables"], g)
    t = torch.tensor(0.3)
    _, (_, dw1, db1, dw2, _) = kfit.ngp_fit_head_loss_and_grad(
        g, W, enc, ntp["W1"], ntp["b1"], ntp["W2"], ntp["b2"], t, kfit.pack_target(g, *_target(g)[:2]))
    np.testing.assert_allclose(dw1[-1].numpy(), (t * db1).numpy(), rtol=1e-6, atol=1e-12)
    assert tuple(dw2.shape) == (16, 4)


def test_gates_take_every_grid_and_bound_lf_and_h():
    for kw in (dict(nx=7, ny=3, nz=1), dict(nx=1, ny=1, nz=1, periodic=False, scheme="upwind"), dict(nx=10, ny=10)):
        assert kfit.fit_supported(GridSpec(**kw))
    assert kfit.fit_smem_bytes(128) == 65536 + 4 * (24 * 128) and kfit.fit_smem_bytes(5) == kfit.fit_smem_bytes(8)
    assert kfit.fit_fits(1) and kfit.fit_fits(128) and kfit.fit_fits(1724) and not kfit.fit_fits(1725)
    assert kfit.fit_smem_bytes(1724) + kfit.FIT_SMEM_STATIC <= kfit.SMEM_LIMIT < kfit.fit_smem_bytes(1728) + kfit.FIT_SMEM_STATIC
    assert kfit.ngp_fit_smem_bytes(16, 64) == 100608
    assert kfit.ngp_fit_fits(16, 64) and kfit.ngp_fit_fits(39, 64) and kfit.ngp_fit_fits(32, 128)
    assert not kfit.ngp_fit_fits(65, 16) and not kfit.ngp_fit_fits(16, 257)


def test_cpu_params_take_the_plain_versions():
    _build.reset_launches()
    g = _grid(16, 8, 3)
    sigma, u, t = _target(g)
    target = kfit.pack_target(g, sigma, u)
    cfg, _, tp = _mlp_setup(g)
    kfit.fit_loss_and_grad(g, cfg, tp, target, t)
    ncfg, _, ntp = _ngp_setup(MIXED)
    kfit.ngp_fit_loss_and_grad(g, ncfg, ntp, target, t)
    assert _build.LAUNCHES["fit"] == 0 and _build.LAUNCHES["fit_ngp"] == 0


def test_bf16_tiers_raise():
    """K6 has its bf16 tier (held to JAX in tests/test_torch_bf16.py): it
    runs and rounds; K7's bf16 tier is still to port and raises."""
    g = _grid(16, 8, 3)
    sigma, u, t = _target(g)
    target = kfit.pack_target(g, sigma, u)
    cfg, _, tp = _mlp_setup(g)
    ncfg, _, ntp = _ngp_setup(MIXED)
    loss, (gp, _) = kfit.fit_loss_and_grad(g, cfg, tp, target, t, precision="bf16")
    _, (gp32, _) = kfit.fit_loss_and_grad(g, cfg, tp, target, t)
    assert bool(torch.isfinite(loss)) and not torch.equal(gp["W2"], gp32["W2"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        kfit.ngp_fit_loss_and_grad(g, ncfg, ntp, target, t, precision="bf16")
