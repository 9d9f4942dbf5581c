"""The port's encoders (phys_autodiff_tpu_torch/models: hash_encoder,
fourier, encoders) vs the JAX package's, on the same numpy inputs.

Hash tables are drawn from the same numpy MT19937 stream: bitwise equal.
Encodings are float32 programs of the same arithmetic in both packages
(gathers, lerps with the same float64-built weights, resampling matmuls in
full float32), held to rel-L2 1e-6 and 1e-6 absolute; sin / cos of the
Fourier features may differ by an ulp between libraries (the same bound
holds). The pull-back to the tables (autograd here, jax.vjp there) sums
cotangents in another order: 1e-5 relative per leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import encoders as jenc
from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.models import encoders, fourier, hash_encoder
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jfourier)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


# tests/test_mega_ngp.py's ENC: r = 4 (hashed), 6 and 8 (dense)
ENC = HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                         dense_oversubscribed=True)
HASH_ONLY = HashEncodingConfig(num_levels=4, features_per_level=2, log2_table_size=10, base_resolution=4,
                               max_resolution=32)
FOURIER = FourierEncodingConfig(num_frequencies=3)
CFGS = {"dense-mix": ENC, "hash-only": HASH_ONLY, "fourier": FOURIER}
GRIDS = {"shaped": (128, 8, 6), "flat": (64, 16, 6), "nz1": (12, 5, 1)}


def _tables(cfg, seed=3):
    """Tables of both packages from one draw, scaled to O(1) features."""
    jt = jenc.init_params(_jax(cfg), seed=seed)
    jt = jax.tree_util.tree_map(lambda a: a * 2000.0, jt)
    return jt, tree.map_tree(lambda a: torch.tensor(np.asarray(a)), jt)


def _close(a, b, rel=1e-6, mx=1e-6):
    a, b = a.detach().numpy(), np.asarray(b)
    assert a.shape == b.shape
    assert rel_l2_err(a, b) <= rel
    assert max_abs_err(a, b) <= mx


@pytest.mark.parametrize(
    "cfg",
    [ENC, HASH_ONLY, HashEncodingConfig(dense_oversubscribed=True), HashEncodingConfig()],
    ids=["dense-mix", "hash-only", "flagship-dense", "flagship-hash"],
)
def test_init_hash_params_is_bitwise_the_jax_draw(cfg):
    jt = jhash.init_hash_params(_jax(cfg), seed=11)
    tt = hash_encoder.init_hash_params(cfg, seed=11, device="cpu")
    assert isinstance(tt, dict) == isinstance(jt, dict) == bool(cfg.dense_levels())
    jl, tl = jax.tree_util.tree_leaves(jt), tree.leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert hash_encoder.schedule_meta(cfg) == jhash.schedule_meta(_jax(cfg))
    assert cfg.dense_levels() == _jax(cfg).dense_levels()


@pytest.mark.parametrize("name", list(CFGS))
def test_pointwise_encode_matches_jax(name):
    cfg = CFGS[name]
    jt, tt = _tables(cfg)
    coords = np.random.default_rng(0).uniform(0, 1, (7, 29, 3)).astype(np.float32)
    out_j = jenc.encode(_jax(cfg), jt, jnp.asarray(coords))
    out_t = encoders.encode(cfg, tt, torch.tensor(coords))
    assert tuple(out_t.shape) == (7, 29, cfg.out_dim)
    _close(out_t, out_j)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("name", list(CFGS))
def test_grid_encoders_match_jax(name, grid):
    cfg = CFGS[name]
    nx, ny, nz = GRIDS[grid]
    g = GridSpec(nx=nx, ny=ny, nz=nz)
    jt, tt = _tables(cfg, seed=5)
    grid_t = encoders.encode_grid(cfg, tt, g)
    zcf_t = encoders.encode_grid_zcf(cfg, tt, g)
    assert tuple(grid_t.shape) == g.shape + (cfg.out_dim,)
    assert tuple(zcf_t.shape) == (nz, cfg.out_dim, ny, nx) and zcf_t.is_contiguous()
    _close(grid_t, jenc.encode_grid(_jax(cfg), jt, _jax(g)))
    _close(zcf_t, jenc.encode_grid_zcf(_jax(cfg), jt, _jax(g)))
    # the two layouts hold the same encoding
    _close(zcf_t, torch.movedim(grid_t, -1, 1).numpy(), rel=2e-6)


@pytest.mark.parametrize("name", ["dense-mix", "hash-only"])
def test_pullback_to_the_tables_matches_jax_vjp(name):
    """The NGP step's encoder pull-back: autograd of encode_grid_zcf (the
    transposed resampling matmuls and index_add) vs jax.vjp."""
    cfg = CFGS[name]
    g = GridSpec(nx=128, ny=8, nz=6)
    jt, tt = _tables(cfg, seed=7)
    ct = np.random.default_rng(1).standard_normal((6, cfg.out_dim, 8, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jenc.encode_grid_zcf(_jax(cfg), t, _jax(g)), jt)
    (ref,) = vjp(jnp.asarray(ct))
    leaves = [x.requires_grad_() for x in tree.leaves(tt)]
    out = encoders.encode_grid_zcf(cfg, tree.unflatten(tt, leaves), g)
    grads = torch.autograd.grad(out, leaves, torch.tensor(ct))
    for a, b in zip(grads, jax.tree_util.tree_leaves(ref)):
        assert rel_l2_err(a.numpy(), np.asarray(b)) <= 1e-5


def test_fourier_has_no_parameters_and_matches_jax_features():
    p = fourier.init_params(FOURIER, device="cpu")
    assert p.dtype == torch.float32 and tuple(p.shape) == (0,)
    assert fourier.schedule_meta(FOURIER) == jfourier.schedule_meta(_jax(FOURIER))
    assert FOURIER.out_dim == _jax(FOURIER).out_dim == 21
    v = np.linspace(0, 1, 17, dtype=np.float32)
    _close(fourier._axis_features(FOURIER, torch.tensor(v)), jfourier._axis_features(_jax(FOURIER), jnp.asarray(v)))


def test_registry_dispatches_both_families_and_a_new_one():
    assert encoders.registered_families()[:2] == [HashEncodingConfig, FourierEncodingConfig]
    assert encoders.family_of(ENC).name == "hash" and encoders.family_of(FOURIER).name == "fourier"
    assert encoders.out_dim(ENC) == 6 and encoders.out_dim(FOURIER) == 21
    assert encoders.schedule_meta(FOURIER) != encoders.schedule_meta(ENC)
    with pytest.raises(TypeError, match="unknown encoding config"):
        encoders.family_of(object())

    @dataclasses.dataclass(frozen=True)
    class Toy:
        out_dim: int = 2

    def toy_grid(cfg, params, g):
        return params * torch.ones(g.shape + (2,))

    encoders.register_family(Toy, encoders.EncoderFamily(
        name="toy",
        init_params=lambda cfg, seed, device: torch.full((), float(seed), device=device),
        schedule_meta=lambda cfg: {"toy": 1},
        encode=lambda cfg, params, coords, allow_large: params * coords[..., :2],
        encode_grid=toy_grid,
        encode_grid_zcf=lambda cfg, params, g: torch.movedim(toy_grid(cfg, params, g), -1, 1),
    ))
    p = encoders.init_params(Toy(), seed=3, device="cpu")
    g = GridSpec(nx=4, ny=3, nz=2)
    assert float(encoders.encode_grid_zcf(Toy(), p, g)[1, 1, 2, 3]) == 3.0
    assert encoders.schedule_meta(Toy()) == {"toy": 1}
    with pytest.raises(ValueError, match="already registered"):
        encoders.register_family(Toy, dataclasses.replace(encoders.family_of(ENC)))


def test_pointwise_guard_and_structure_checks():
    jt, tt = _tables(HASH_ONLY)
    big = torch.zeros((hash_encoder.MAX_POINTWISE_POINTS + 1, 3))
    with pytest.raises(ValueError, match="encode_grid"):
        hash_encoder.encode(HASH_ONLY, tt, big)
    with pytest.raises(TypeError, match="dense levels"):
        hash_encoder.encode_grid(ENC, torch.zeros(1, 128, 2), GridSpec(nx=4, ny=4, nz=4))
    # a grid point of a level lands on one hashed corner
    cfg = HashEncodingConfig(num_levels=1, log2_table_size=8, base_resolution=5, max_resolution=5)
    t = hash_encoder.init_hash_params(cfg, seed=1, scale=0.5, device="cpu")
    out = hash_encoder.encode(cfg, t, torch.tensor([[2 / 4, 3 / 4, 1 / 4]]))
    idx = hash_encoder._hash_corner(torch.tensor([2]), torch.tensor([3]), torch.tensor([1]), cfg.table_size)
    jidx = jhash._hash_corner(jnp.asarray([2]), jnp.asarray([3]), jnp.asarray([1]), cfg.table_size)
    assert int(idx[0]) == int(jidx[0])
    np.testing.assert_allclose(out[0].numpy(), t[0, int(idx[0])].numpy(), rtol=1e-5)
