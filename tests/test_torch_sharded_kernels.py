"""The shard-local builds of K4-K7 and the sharded entry points over them
(kernels/mega_bwd.py, mega_ngp.py, fit.py; train/fit_field.py
make_sharded_fit_step) and the shard-local encoders.

Serial shards: on the CPU each shard-local wrapper runs its plain version.
Run for every shard of a 1-, 2- and 4-way split, one after another in one
process, their plane partials chained in z order must give the full-grid
plain version's loss (1e-7: the same per-plane values; 5e-6, the training
steps' class, for K4's, K6's and K7's bf16, whose matmul sums may run in
another order on a shard's shape; K5's plain head sums in float64, 1e-7 in
every tier), their owned-row
outputs (dCD, dEnc) its rows (1e-6; 1e-4 for the bf16 tier, whose dEnc
rounds a sum that the two versions form in other orders), and their summed
gradients its gradients at tests/test_mega_bwd.py:52-58's classes (1e-4
relative L2 on the concatenation, 1e-3 a leaf: float32 sums in other
orders; db2 and dW2 are near-cancelling sums), and one adam step from the
summed gradients the full-grid step's params at 1e-6 relative L2
(tests/test_sharding.py:227-229's class).

Against the JAX package: ports of tests/test_mega_ngp.py:192,
test_fit_kernel.py:160, 189, 318, 349, test_fit_field.py:229,
test_encoders.py:226 and test_fourier.py:153 on gloo groups of 2 and 4
processes (one spawn a world size, the module fixture `gloo`), each held to
its JAX test's tolerances against the JAX function on a mesh of the same
size (Pallas in interpret mode) and against the port's single-device
result.
"""

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phys_autodiff_tpu.models import encoders as jencoders
from phys_autodiff_tpu.models import fourier as jfourier_mod
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.models.fourier import FourierEncodingConfig as JFourierCfg
from phys_autodiff_tpu.pallas import fit as jfit
from phys_autodiff_tpu.pallas.mega_ngp import ngp_loss_and_grad_sharded as jngp_sharded
from phys_autodiff_tpu.parallel import make_mesh as jmake_mesh
from phys_autodiff_tpu.train import TrainConfig as JTrainConfig
from phys_autodiff_tpu.train import fit_field as jff
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega_bwd as kb
from phys_autodiff_tpu_torch.kernels import mega_ngp as kn
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels.residuals import sum_plane_partials
from phys_autodiff_tpu_torch.models import encoders, fourier, mlp, ngp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.parallel.launch import run_gloo
from phys_autodiff_tpu_torch.parallel.mesh import shard_rows
from phys_autodiff_tpu_torch.train import TrainConfig
from phys_autodiff_tpu_torch.train import fit_field as ff
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

SIZES = (2, 4)
W = PhysWeights(w_sigma=1.3, w_u=0.7)
ENC = HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                         dense_oversubscribed=True)
FIT_ENC = HashEncodingConfig(num_levels=3, features_per_level=2, log2_table_size=9, base_resolution=3,
                             max_resolution=12)


# ---------------------------------------------------------------------------
# A registered family with parameters (tests/test_encoders.py's toy), in
# both packages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GainedFourierConfig:
    """Fourier features with a learned per-channel gain."""

    base: FourierEncodingConfig = FourierEncodingConfig(num_frequencies=2)

    @property
    def out_dim(self) -> int:
        return self.base.out_dim


@dataclasses.dataclass(frozen=True)
class JGainedFourierConfig:
    base: JFourierCfg = JFourierCfg(num_frequencies=2)

    @property
    def out_dim(self) -> int:
        return self.base.out_dim


def _gf_init_np(out_dim, seed):
    rng = np.random.Generator(np.random.MT19937(seed + 11))
    return (1.0 + 0.2 * rng.standard_normal(out_dim)).astype(np.float32)


def _register_toys():
    encoders.register_family(GainedFourierConfig, encoders.EncoderFamily(
        name="gained_fourier",
        init_params=lambda cfg, seed, device: torch.tensor(_gf_init_np(cfg.out_dim, seed), device=device),
        schedule_meta=lambda cfg: {"toy_gained_fourier_k": cfg.base.num_frequencies},
        encode=lambda cfg, p, coords, allow_large: fourier.encode(cfg.base, coords) * p,
        encode_grid=lambda cfg, p, g: fourier.encode_grid(cfg.base, g, p.device) * p,
        encode_grid_zcf=lambda cfg, p, g: fourier.encode_grid_zcf(cfg.base, g, p.device) * p[None, :, None, None],
        encode_grid_zcf_rows=lambda cfg, p, g, rows: (
            fourier.encode_grid_zcf_rows(cfg.base, g, rows, p.device) * p[None, :, None, None]),
    ))


def _register_jax_toy():
    jencoders.register_family(JGainedFourierConfig, jencoders.EncoderFamily(
        name="gained_fourier",
        init_params=lambda cfg, seed: jnp.asarray(_gf_init_np(cfg.out_dim, seed)),
        schedule_meta=lambda cfg: {"toy_gained_fourier_k": cfg.base.num_frequencies},
        encode=lambda cfg, p, coords, allow_large: jfourier_mod.encode(cfg.base, coords) * p,
        encode_grid=lambda cfg, p, g: jfourier_mod.encode_grid(cfg.base, g) * p,
        encode_grid_zcf=lambda cfg, p, g: jfourier_mod.encode_grid_zcf(cfg.base, g) * p[None, :, None, None],
        encode_grid_zcf_rows=lambda cfg, p, g, rows: (
            jfourier_mod.encode_grid_zcf_rows(cfg.base, g, rows) * p[None, :, None, None]),
    ))


_register_jax_toy()
TOY = GainedFourierConfig()


@pytest.fixture(scope="module", autouse=True)
def _toy_family():
    """The port's toy family, registered while this module's tests run (the
    port's registry is what `cli info` lists: other modules must not see
    it); a spawned rank registers its own (_rank_checks)."""
    saved = dict(encoders._REGISTRY)
    _register_toys()
    yield
    encoders._REGISTRY.clear()
    encoders._REGISTRY.update(saved)
FOURIER = FourierEncodingConfig(num_frequencies=2, include_input=True)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if isinstance(x, GainedFourierConfig):
        return JGainedFourierConfig(_jax(x.base))
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in (jconfig, jhash, jfourier_mod, jngp) if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _leaves(t):
    if isinstance(t, torch.Tensor):
        return [t.detach().numpy()]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]


def _to_np(t):
    return jax.tree_util.tree_map(lambda x: x.detach().numpy().copy() if isinstance(x, torch.Tensor) else x, t)


# ---------------------------------------------------------------------------
# Serial shards: the shard-local plain versions add up to the full grid
# ---------------------------------------------------------------------------


def _serial_grid(periodic, scheme="central"):
    return GridSpec(nx=16, ny=8, nz=8, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)


def _adam_params(params, grads):
    """One optax.adam step (lr 1e-3) from numpy params and gradients."""
    opt = optax.adam(1e-3)
    up, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, up)


def _loss_tol(tier):
    """f32: the same per-plane values, 1e-7; bf16 of K4, K6 and K7: their
    plain layer 2 sums a shard's rows in a float32 matmul of another shape,
    whose order may differ in the last bit, so the training steps' 5e-6.
    K5's plain head sums its products in float64 and the shard-local
    encoder's z contraction is exact (kernels/mega_ngp._mm64,
    models/hash_encoder._lerp_z), so a shard's fields are the whole grid's
    bits in every tier: 1e-7 for each."""
    return 1e-7 if tier != "bf16" else 5e-6


def _check_sums(full_loss, full_grads, loss, grads, row_idx, row_tol, params, loss_tol=1e-7):
    """full_grads / grads: lists of leaves; row_idx: the leaves given by
    rows (compared whole); params: the leaves' params for the adam step."""
    assert abs(float(loss) - float(full_loss)) <= loss_tol * abs(float(full_loss))
    fa = np.concatenate([np.ravel(x) for x in full_grads])
    ga = np.concatenate([np.ravel(x) for x in grads])
    assert _rel(ga, fa) < 1e-4
    for i, (a, b) in enumerate(zip(grads, full_grads)):
        assert _rel(a, b) < (row_tol if i in row_idx else 1e-3), i
    if params is not None:
        pa = _adam_params([jnp.asarray(p) for p in params], [jnp.asarray(x) for x in grads])
        pb = _adam_params([jnp.asarray(p) for p in params], [jnp.asarray(x) for x in full_grads])
        for a, b in zip(pa, pb):
            assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_k4_shards_add_up_to_the_full_grid(tier, periodic, scheme, n):
    g = _serial_grid(periodic, scheme)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    tabs = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=3, device="cpu"), slice_times(0.25, g.dt))
    loss, full = kb.table_loss_and_grad_plain(g, W, *tabs, tier)
    nzl = g.nz // n
    res = [kb.table_loss_and_grad_shard(g, W, *tabs, r * nzl, nzl, tier) for r in range(n)]
    got_loss = sum_plane_partials(g, W, torch.cat([r[0] for r in res], 1))
    got = [sum(r[1][i] for r in res) for i in range(4)]
    got[1] = torch.cat([r[1][1] for r in res], 0)
    _check_sums(loss.sum(), [x.numpy() for x in full], got_loss.sum(), [x.numpy() for x in got], {1}, 1e-6,
                [x.numpy() for x in tabs], _loss_tol(tier))


def _ngp_params(ncfg, seed=7, scale_tables=True):
    jp = jngp.init_ngp_params(_jax(ncfg), seed=seed)
    rng = np.random.Generator(np.random.MT19937(21))
    if scale_tables:
        jp["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jp["tables"])
    jp["b1"] = jnp.asarray(rng.standard_normal(jp["b1"].shape) * 0.3, jnp.float32)
    jp["b2"] = jnp.asarray(rng.standard_normal(jp["b2"].shape) * 0.3, jnp.float32)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("tier", ["f32", "bf16", "f32_fastbwd"])
def test_k5_shards_add_up_to_the_full_grid(tier, periodic, n):
    g = _serial_grid(periodic, "upwind" if not periodic else "central")
    ncfg = ngp.NGPFieldConfig(encoding=ENC, hidden=16)
    p = ngp.params_from_jax(_ngp_params(ncfg)[1], device="cpu")
    ts = slice_times(torch.tensor(0.3), g.dt)
    head = (p["W1"], p["b1"], p["W2"], p["b2"])
    enc = encoders.encode_grid_zcf(ENC, p["tables"], g)
    loss, full = kn.head_loss_and_grad_plain(g, W, enc, *head, ts, tier)
    nzl = g.nz // n
    res = []
    for r in range(n):
        e = encoders.encode_grid_zcf_rows(ENC, p["tables"], g, kb.halo_rows(g, r * nzl, nzl))
        res.append(kn.head_loss_and_grad_shard(g, W, e, *head, ts, r * nzl, nzl, tier))
    got_loss = sum_plane_partials(g, W, torch.cat([r[0] for r in res], 1))
    got = [torch.cat([r[1][0] for r in res], 0)] + [sum(r[1][i] for r in res) for i in range(1, 5)]
    _check_sums(loss.sum(), [x.numpy() for x in full], got_loss.sum(), [x.numpy() for x in got], {0},
                1e-6 if tier != "bf16" else 1e-4, [x.numpy() for x in (enc, *head)], _loss_tol("f32"))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_encode_grid_zcf_rows_are_the_full_rows_on_every_shard(periodic, n):
    """The shard-local encoder's rows (a shard's and its halo rows) are the
    whole encode's rows, bit for bit, on the grids the K5 shard sums use:
    the z contraction of the corner lattice runs in float64 and rounds once
    (hash_encoder._lerp_z), so its bits do not depend on how many rows it
    makes or on the machine's GEMM kernels."""
    g = _serial_grid(periodic)
    p = ngp.params_from_jax(_ngp_params(ngp.NGPFieldConfig(encoding=ENC, hidden=16))[1], device="cpu")
    full = encoders.encode_grid_zcf(ENC, p["tables"], g)
    nzl = g.nz // n
    for r in range(n):
        rows = kb.halo_rows(g, r * nzl, nzl)
        assert torch.equal(encoders.encode_grid_zcf_rows(ENC, p["tables"], g, rows), full[rows])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_k6_shards_add_up_to_the_full_grid(tier, n):
    g = GridSpec(nx=16, ny=8, nz=8, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    tabs = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=7, device="cpu"), torch.tensor([0.3]))
    rng = np.random.default_rng(7)
    target = kfit.pack_target(g, rng.normal(size=g.shape).astype(np.float32),
                              (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32))
    loss, full = kfit.fit_table_loss_and_grad_plain(g, W, *tabs, target, tier)
    nzl = g.nz // n
    res = [kfit.fit_table_loss_and_grad_shard(g, W, *tabs, target[r * nzl:(r + 1) * nzl], r * nzl, nzl, tier)
           for r in range(n)]
    got_loss = sum_plane_partials(g, W, torch.cat([r[0] for r in res], 1))
    got = [sum(r[1][i] for r in res) for i in range(4)]
    got[1] = torch.cat([r[1][1] for r in res], 0)
    _check_sums(loss.sum(), [x.numpy() for x in full], got_loss.sum(), [x.numpy() for x in got], {1}, 1e-6,
                [x.numpy() for x in tabs], _loss_tol(tier))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_k7_shards_add_up_to_the_full_grid(tier, n):
    g = GridSpec(nx=16, ny=8, nz=8, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
    ncfg = ngp.NGPFieldConfig(encoding=ENC, hidden=16)
    p = ngp.params_from_jax(_ngp_params(ncfg)[1], device="cpu")
    rng = np.random.default_rng(11)
    target = kfit.pack_target(g, rng.normal(size=g.shape).astype(np.float32),
                              (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32))
    t = torch.tensor(0.3)
    head = (p["W1"], p["b1"], p["W2"], p["b2"])
    enc = encoders.encode_grid_zcf(ENC, p["tables"], g)
    loss, full = kfit.ngp_fit_head_loss_and_grad_plain(g, W, enc, *head, t, target, tier)
    nzl = g.nz // n
    res = [kfit.ngp_fit_head_loss_and_grad_shard(g, W, enc[r * nzl:(r + 1) * nzl], *head, t,
                                                 target[r * nzl:(r + 1) * nzl], r * nzl, nzl, tier)
           for r in range(n)]
    got_loss = sum_plane_partials(g, W, torch.cat([r[0] for r in res], 1))
    got = [torch.cat([r[1][0] for r in res], 0)] + [sum(r[1][i] for r in res) for i in range(1, 5)]
    _check_sums(loss.sum(), [x.numpy() for x in full], got_loss.sum(), [x.numpy() for x in got], {0}, 1e-6,
                [x.numpy() for x in (enc, *head)], _loss_tol(tier))


@pytest.mark.parametrize("case", ["K4 f32", "K4 bf16", "K5 f32"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_shard_referees_are_the_plain_versions_in_float64(case, periodic):
    """The referees the card holds K4's and K5's shard-local kernels to
    (kernels/mega_bwd.table_loss_and_grad_shard_ref: the pull-back in
    float64; kernels/mega_ngp.head_loss_and_grad_shard_ref: head_fields_ref
    in float64) give the plain versions' partials and gradients at these
    sizes, where float32's cancellation is small: 1e-6 on the partials,
    1e-4 a leaf (the bf16 tier's db2, a float32 sum of rounded operands in
    the plain version, within 1e-3)."""
    g = _serial_grid(periodic, "upwind" if not periodic else "central")
    if case.startswith("K4"):
        tier = case.split()[1]
        cfg = MLPGridConfig(dims=MLPDims(H=16))
        tabs = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=3, device="cpu"), slice_times(0.25, g.dt))
        pairs = [(kb.table_loss_and_grad_shard_plain(g, W, *tabs, z0, 4, tier),
                  kb.table_loss_and_grad_shard_ref(g, W, *tabs, z0, 4, tier)) for z0 in (0, 4)]
    else:
        p = ngp.params_from_jax(_ngp_params(ngp.NGPFieldConfig(encoding=ENC, hidden=16))[1], device="cpu")
        ts = slice_times(torch.tensor(0.3), g.dt)
        head = (p["W1"], p["b1"], p["W2"], p["b2"])
        pairs = []
        for z0 in (0, 4):
            e = encoders.encode_grid_zcf_rows(ENC, p["tables"], g, kb.halo_rows(g, z0, 4))
            pairs.append((kn.head_loss_and_grad_shard_plain(g, W, e, *head, ts, z0, 4),
                          kn.head_loss_and_grad_shard_ref(g, W, e, *head, ts, z0, 4)))
    for plain, ref in pairs:
        assert ref[0].dtype == torch.float32 and all(x.dtype == torch.float32 for x in ref[1])
        assert _rel(plain[0].numpy(), ref[0].numpy()) < 1e-6
        for i, (a, b) in enumerate(zip(plain[1], ref[1])):
            assert _rel(a.numpy(), b.numpy()) < (1e-3 if case == "K4 bf16" and i == 3 else 1e-4), i


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_halo_rows_and_the_residual_range(periodic):
    """A shard's field rows are z0 - 2 .. z0 + nz_local + 1 under the global
    wrap or clamp; its residual rows reach one row past each end, within
    the grid when clamped."""
    g = _serial_grid(periodic)
    rows = kb.halo_rows(g, 0, 4).tolist()
    assert rows == ([6, 7, 0, 1, 2, 3, 4, 5] if periodic else [0, 0, 0, 1, 2, 3, 4, 5])
    assert kb.residual_range(g, 4, 4) == ((3, 8) if periodic else (3, 7))
    assert kb.residual_range(g, 0, 8) == (0, 7)
    with pytest.raises(ValueError, match="not a shard"):
        kb.check_shard(g, 4, 8)


@pytest.mark.parametrize("family", ["hash", "hash-fast", "fourier", "toy"])
def test_encode_grid_zcf_rows_are_the_full_rows(family):
    """The shard-local encoders (tests/test_encoders.py:205-223): every row
    the full encode's row, bit for bit (fast: the fast encode's), and JAX's
    rows (1e-6; the fast encode within the bf16 tier's 5e-2 of JAX's, which
    the CPU backend computes exactly)."""
    g = GridSpec(nx=12, ny=7, nz=9, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    cfg, fast = {"hash": (ENC, False), "hash-fast": (ENC, True), "fourier": (FOURIER, False),
                 "toy": (TOY, False)}[family]
    p = encoders.init_params(cfg, seed=3, device="cpu")
    if family.startswith("hash"):
        p = tree.map_tree(lambda x: x * 2000.0, p)
    rows = torch.tensor([7, 8, 0, 1, 2, 0, 4])
    full = encoders.encode_grid_zcf(cfg, p, g, fast=fast)
    sub = encoders.encode_grid_zcf_rows(cfg, p, g, rows, fast=fast)
    assert torch.equal(sub, full[rows])
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), p)
    jsub = jencoders.encode_grid_zcf_rows(_jax(cfg), jp, _jax(g), jnp.asarray(rows.numpy()), fast=fast)
    if fast:  # JAX's CPU backend runs its DEFAULT precision exactly: the tier's 5e-2 contract
        assert _rel(sub.numpy(), np.asarray(jsub)) < 5e-2
    else:
        np.testing.assert_allclose(sub.numpy(), np.asarray(jsub), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The sharded entry points on gloo groups, against JAX's on a mesh
# ---------------------------------------------------------------------------


# tests/test_mega_ngp.py's grid at nx = 16: ny * nx = 128, a plane the JAX
# kernel takes in its flat layout, an eighth of the interpret-mode work
G_NGP = {True: GridSpec(nx=16, ny=8, nz=16, hx=0.3, hy=0.3, hz=0.3, dt=1e-2),
         False: GridSpec(nx=16, ny=8, nz=16, hx=0.3, hy=0.3, hz=0.3, dt=1e-2, periodic=False)}
G_FIT = GridSpec(nx=16, ny=8, nz=16, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
G_FIT_SMALL = GridSpec(nx=8, ny=8, nz=8, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
FIT_MLP = MLPGridConfig(dims=MLPDims(H=8))
FIT_NGP = ngp.NGPFieldConfig(encoding=FIT_ENC, hidden=16)
NGP_CFGS = {"hash": ngp.NGPFieldConfig(encoding=ENC, hidden=16),
            "fourier": ngp.NGPFieldConfig(encoding=FOURIER, hidden=16),
            "toy": ngp.NGPFieldConfig(encoding=TOY, hidden=16)}


def _fit_target(g, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=g.shape).astype(np.float32), (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32),
            0.3)


def _smooth_target(g, t=0.25):
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    xs, ys, zs = x / g.nx, y / g.ny, z / g.nz
    sigma = 0.5 * np.sin(2 * np.pi * xs) * np.cos(2 * np.pi * ys)
    u = np.stack([0.3 * np.cos(2 * np.pi * zs), 0.2 * np.sin(2 * np.pi * xs), 0.1 * np.ones_like(xs)])
    return sigma.astype(np.float32), u.astype(np.float32), t


@functools.lru_cache(maxsize=None)
def _inputs():
    ngp_params = {name: _ngp_params(c, scale_tables=name == "hash")[1] for name, c in NGP_CFGS.items()}
    return {
        "ngp": ngp_params,
        "fit_mlp": {k: np.asarray(v) for k, v in jff.init_any(_jax(FIT_MLP), seed=7).items()},
        "fit_ngp": jax.tree_util.tree_map(np.asarray, jff.init_any(_jax(FIT_NGP), seed=11)),
        "targets": {"fit_mlp": _fit_target(G_FIT, 7), "steps_mlp": _fit_target(G_FIT, 9),
                    "fit_ngp": _fit_target(G_FIT, 11), "steps_ngp": _fit_target(G_FIT, 13),
                    "single": _smooth_target(G_FIT_SMALL)},
    }


def _target(arrays):
    return ff.FitTarget(torch.tensor(arrays[0]), torch.tensor(arrays[1]), arrays[2])


def _fit_steps(mesh, g, model_cfg, tgt, tc, phys_weight, engine):
    step, init = ff.make_sharded_fit_step(g, model_cfg, [tgt], mesh, tc, phys_weight=phys_weight, engine=engine)
    state = init()
    losses = []
    for _ in range(tc.steps):
        state, loss = step(state)
        losses.append(float(loss))
    return losses, _to_np(state.params)


def _rank_checks(mesh, inp):
    _register_toys()  # a spawned rank imports this module afresh
    out = {}
    for name, ncfg in NGP_CFGS.items():
        for periodic in ((True, False) if name == "hash" else (True,)):
            p = ngp.params_from_jax(inp["ngp"][name], device="cpu")
            loss, (grads, d_t) = kn.ngp_loss_and_grad_sharded(G_NGP[periodic], W, ncfg, mesh)(p, 0.3)
            out[f"ngp/{name}/{periodic}"] = (float(loss), _to_np(grads), float(d_t))
    w_fit = PhysWeights(w_sigma=1.1, w_u=0.9)
    sig, u, t = inp["targets"]["fit_mlp"]
    packed = shard_rows(mesh, kfit.pack_target(G_FIT, sig, u))
    loss, (grads, d_t) = kfit.fit_loss_and_grad_sharded(G_FIT, FIT_MLP, mesh, w_fit)(
        mlp.params_from_jax(inp["fit_mlp"], device="cpu"), packed, t)
    out["fit"] = (float(loss), _to_np(grads), float(d_t))
    w_ngp = PhysWeights(w_sigma=1.05, w_u=0.95)
    sig, u, t = inp["targets"]["fit_ngp"]
    packed = shard_rows(mesh, kfit.pack_target(G_FIT, sig, u))
    loss, (grads, d_t) = kfit.ngp_fit_loss_and_grad_sharded(G_FIT, FIT_NGP, mesh, w_ngp)(
        ngp.params_from_jax(inp["fit_ngp"], device="cpu"), packed, t)
    out["ngp_fit"] = (float(loss), _to_np(grads), float(d_t))
    for eng in ("xla", "mega"):
        out[f"steps_mlp/{eng}"] = _fit_steps(mesh, G_FIT, FIT_MLP, _target(inp["targets"]["steps_mlp"]),
                                             TrainConfig(steps=4, learning_rate=1e-3, seed=6), 0.3, eng)
        out[f"steps_ngp/{eng}"] = _fit_steps(mesh, G_FIT, FIT_NGP, _target(inp["targets"]["steps_ngp"]),
                                             TrainConfig(steps=3, learning_rate=3e-3, seed=8), 0.2, eng)
    out["single"] = _fit_steps(mesh, G_FIT_SMALL, FIT_MLP, _target(inp["targets"]["single"]),
                               TrainConfig(steps=5, learning_rate=1e-3, seed=4), 0.3, "xla")
    return out


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def gloo(request):
    """(world size, the inputs, rank 0's results of _rank_checks)."""
    inp = _inputs()
    return request.param, inp, run_gloo(_rank_checks, request.param, inp)[0]


def _leaf_close(a, b, tol):
    return np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) <= tol * max(
        np.linalg.norm(np.asarray(b, np.float64)), 1e-30)


@functools.lru_cache(maxsize=None)
def _ngp_single(name, periodic):
    """The single-device ngp_loss_and_grad (its plain version) of a case:
    one run serves both world sizes."""
    p = ngp.params_from_jax(_inputs()["ngp"][name], device="cpu")
    l1, (g1, dt1) = kn.ngp_loss_and_grad(G_NGP[periodic], W, NGP_CFGS[name], p, 0.3)
    return l1, _to_np(g1), dt1


def _check_ngp(got, ref_loss, ref_grads, ref_dt, loss_tol, leaf_tol, dt_tol, cat_tol=None):
    loss, grads, d_t = got
    assert abs(loss - float(ref_loss)) <= loss_tol * abs(float(ref_loss))
    a_leaves, b_leaves = _leaves(grads), _leaves(ref_grads)
    for a, b in zip(a_leaves, b_leaves):
        assert _leaf_close(a, b, leaf_tol)
    if cat_tol is not None:
        assert _rel(np.concatenate([np.ravel(x) for x in a_leaves]),
                    np.concatenate([np.ravel(x) for x in b_leaves])) < cat_tol
    assert abs(d_t - float(ref_dt)) <= max(dt_tol * abs(float(ref_dt)), 1e-7)


@pytest.mark.parametrize("name,periodic", [("hash", True), ("hash", False), ("fourier", True), ("toy", True)],
                         ids=["hash-periodic", "hash-clamp", "fourier", "toy"])
def test_ngp_mega_sharded_matches_single(gloo, name, periodic):
    """K5's shard-local build a rank (its plain version here), the
    shard-local encoders and the all-reduced table pull-back against the
    single-device ngp_loss_and_grad and JAX's ngp_loss_and_grad_sharded
    (tests/test_mega_ngp.py:192, test_fourier.py:153 with an empty table
    gradient, test_encoders.py:226 for a registered family). The JAX test
    holds one kernel's sharded and single-device runs to each other (loss
    5e-6, leaves 1e-5); the plain versions are float32 autograd, whose
    slice-by-slice sums of the t -+ dt legs lose about 1e-5 of dW2 a run
    (kernels/mega_ngp.py head_loss_and_grad_ref), so the port's sharded run
    is held to its single-device run at the serial shards' classes (loss
    5e-6, 1e-4 on the concatenation, 1e-3 a leaf and d_t), and to JAX's at
    tests/test_torch_mega_ngp.py's (loss 1e-5, leaves 1e-4, 5e-3 clamped,
    d_t 5e-3)."""
    n, inp, res = gloo
    g, ncfg = G_NGP[periodic], NGP_CFGS[name]
    got = res[f"ngp/{name}/{periodic}"]
    _check_ngp(got, *_ngp_single(name, periodic), 5e-6, 1e-3, 1e-3, cat_tol=1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, inp["ngp"][name])
    ln, (gn, dtn) = jax.jit(jngp_sharded(_jax(g), _jax(W), _jax(ncfg), jmake_mesh(n), interpret=True))(
        jp, jnp.float32(0.3))
    _check_ngp(got, ln, gn, dtn, 1e-5, 1e-4 if periodic else 5e-3, 5e-3)
    if name == "fourier":
        assert got[1]["tables"].size == 0
    else:
        assert np.abs(got[1]["tables"] if name == "toy" else np.concatenate(
            [np.ravel(x) for x in _leaves(got[1]["tables"])])).sum() > 0


def test_sharded_fit_kernel_matches_single_chip(gloo):
    """K6 on each rank's rows against the single-device K6 (plain) and JAX's
    fit_loss_and_grad_sharded: loss 1e-7, each leaf 1e-5 (atol 1e-8)."""
    n, inp, res = gloo
    loss, grads, gt = res["fit"]
    sig, u, t = inp["targets"]["fit_mlp"]
    w = PhysWeights(w_sigma=1.1, w_u=0.9)
    l1, (gp1, _) = kfit.fit_loss_and_grad(G_FIT, FIT_MLP, mlp.params_from_jax(inp["fit_mlp"], device="cpu"),
                                          kfit.pack_target(G_FIT, sig, u), t, w)
    np.testing.assert_allclose(loss, float(l1), rtol=1e-7)
    for k in gp1:
        np.testing.assert_allclose(grads[k], gp1[k].detach().numpy(), rtol=1e-5, atol=1e-8, err_msg=k)
    lag = jfit.fit_loss_and_grad_sharded(_jax(G_FIT), _jax(FIT_MLP), jmake_mesh(n), _jax(w), interpret=True)
    packed = jfit.pack_target(_jax(G_FIT), jnp.asarray(sig), jnp.asarray(u))
    lj, (gpj, _) = jax.jit(lag)({k: jnp.asarray(v) for k, v in inp["fit_mlp"].items()},
                                jax.device_put(packed, lag.target_sharding), jnp.float32(t))
    np.testing.assert_allclose(loss, float(lj), rtol=1e-6)
    for k in gpj:
        np.testing.assert_allclose(grads[k], np.asarray(gpj[k]), rtol=1e-5, atol=1e-8, err_msg=k)


def test_sharded_ngp_fit_kernel_matches_single_chip(gloo):
    """K7 on each rank's rows (its own rows encoded) against the
    single-device K7 and JAX's ngp_fit_loss_and_grad_sharded: loss 1e-7,
    the flattened gradient 1e-5, d_t 1e-5."""
    n, inp, res = gloo
    loss, grads, gt = res["ngp_fit"]
    sig, u, t = inp["targets"]["fit_ngp"]
    w = PhysWeights(w_sigma=1.05, w_u=0.95)
    l1, (gp1, gt1) = kfit.ngp_fit_loss_and_grad(G_FIT, FIT_NGP, ngp.params_from_jax(inp["fit_ngp"], device="cpu"),
                                                kfit.pack_target(G_FIT, sig, u), t, w)
    np.testing.assert_allclose(loss, float(l1), rtol=1e-7)
    flat = np.concatenate([np.ravel(x) for x in _leaves(grads)])
    assert _rel(flat, np.concatenate([np.ravel(x) for x in _leaves(_to_np(gp1))])) < 1e-5
    np.testing.assert_allclose(gt, float(gt1), rtol=1e-5, atol=1e-9)
    lag = jfit.ngp_fit_loss_and_grad_sharded(_jax(G_FIT), _jax(FIT_NGP), jmake_mesh(n), _jax(w), interpret=True)
    packed = jfit.pack_target(_jax(G_FIT), jnp.asarray(sig), jnp.asarray(u))
    lj, (gpj, gtj) = jax.jit(lag)(jax.tree_util.tree_map(jnp.asarray, inp["fit_ngp"]),
                                  jax.device_put(packed, lag.target_sharding), jnp.float32(t))
    np.testing.assert_allclose(loss, float(lj), rtol=1e-6)
    assert _rel(flat, np.concatenate([np.ravel(x) for x in _leaves(gpj)])) < 1e-5
    np.testing.assert_allclose(gt, float(gtj), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("family", ["mlp", "ngp"])
def test_sharded_fit_step_mega_matches_xla_arm(gloo, family):
    """make_sharded_fit_step(engine="mega") tracks its xla arm, the PINN
    composite included (tests/test_fit_kernel.py:189 and :349: losses 1e-5
    / 2e-5 a step, params 3e-4), and both track JAX's mega arm on a mesh of
    the same size (the same classes)."""
    n, inp, res = gloo
    (lm, pm), (lx, px) = res[f"steps_{family}/mega"], res[f"steps_{family}/xla"]
    rtol = 1e-5 if family == "mlp" else 2e-5
    np.testing.assert_allclose(np.asarray(lm), np.asarray(lx), rtol=rtol)
    fm = np.concatenate([np.ravel(x) for x in _leaves(pm)])
    fx = np.concatenate([np.ravel(x) for x in _leaves(px)])
    assert _rel(fm, fx) < 3e-4
    cfg = FIT_MLP if family == "mlp" else FIT_NGP
    sig, u, t = inp["targets"][f"steps_{family}"]
    tc = (JTrainConfig(steps=4, learning_rate=1e-3, seed=6) if family == "mlp"
          else JTrainConfig(steps=3, learning_rate=3e-3, seed=8))
    step, init = jff.make_sharded_fit_step(_jax(G_FIT), _jax(cfg), [jff.FitTarget(jnp.asarray(sig), jnp.asarray(u), t)],
                                           jmake_mesh(n), tc, phys_weight=0.3 if family == "mlp" else 0.2,
                                           engine="mega", interpret=True)
    params, opt_state = init()
    lj = []
    for _ in range(tc.steps):
        params, opt_state, loss = step(params, opt_state)
        lj.append(float(loss))
    np.testing.assert_allclose(np.asarray(lm), np.asarray(lj), rtol=rtol)
    assert _rel(fm, np.concatenate([np.ravel(x) for x in _leaves(params)])) < 3e-4


def test_sharded_fit_step_matches_single_chip(gloo):
    """The xla arm of make_sharded_fit_step tracks the single-device
    fit_field (tests/test_fit_field.py:229: losses 1e-5 a step, params
    2e-4 with atol 1e-6), and JAX's sharded fit step on a mesh of the same
    size."""
    n, inp, res = gloo
    losses, params = res["single"]
    sig, u, t = inp["targets"]["single"]
    tc = TrainConfig(steps=5, learning_rate=1e-3, seed=4)
    p1, l1 = ff.fit_field(G_FIT_SMALL, FIT_MLP, [_target(inp["targets"]["single"])], tc, phys_weight=0.3,
                          device="cpu")
    np.testing.assert_allclose(np.asarray(losses), l1.numpy(), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(params[k], p1[k].numpy(), rtol=2e-4, atol=1e-6, err_msg=k)
    step, init = jff.make_sharded_fit_step(_jax(G_FIT_SMALL), _jax(FIT_MLP),
                                           [jff.FitTarget(jnp.asarray(sig), jnp.asarray(u), t)], jmake_mesh(n),
                                           JTrainConfig(steps=5, learning_rate=1e-3, seed=4), phys_weight=0.3)
    pj, oj = init()
    lj = []
    for _ in range(5):
        pj, oj, loss = step(pj, oj)
        lj.append(float(loss))
    np.testing.assert_allclose(np.asarray(losses), np.asarray(lj), rtol=1e-5)
    for k in pj:
        np.testing.assert_allclose(params[k], np.asarray(pj[k]), rtol=2e-4, atol=1e-6, err_msg=k)
