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
from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig
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


def test_registry_dispatches_both_families_and_a_new_one(monkeypatch):
    # The new family goes into a copy of the registry that the test drops at
    # its end, so no later test in the process sees it (the CLI's `info`
    # lists the registered families).
    monkeypatch.setattr(encoders, "_REGISTRY", dict(encoders._REGISTRY))
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


# ---------------------------------------------------------------------------
# The deterministic pull-back: resampling matmuls and the inverse-table gather
# ---------------------------------------------------------------------------


def _index_add_encode_grid(cfg, tables, g, zcf):
    """The grid encoder as it was before the pull-back became deterministic:
    hashed levels gathered with plain indexing (backward: index_add) and
    resampled with index_select (backward: index_add)."""

    def lerp(grid, n, r, axis):
        if n == 1:
            i0, w = np.zeros(1, np.int64), np.zeros(1, np.float32)
        else:
            pos = np.arange(n, dtype=np.float64) / (n - 1) * (r - 1)
            i0 = np.floor(pos).astype(np.int64)
            w = (pos - i0).astype(np.float32)
        shape = [1] * grid.ndim
        shape[axis] = n
        wv = torch.tensor(w).reshape(shape)
        lo = torch.index_select(grid, axis, torch.tensor(i0))
        hi = torch.index_select(grid, axis, torch.tensor(i0 + 1))
        return lo * (1.0 - wv) + hi * wv

    hash_tables, dense = hash_encoder._tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = dense[lvl]
            res = hash_encoder._axis_lerp_dense
        else:
            idx, _ = hash_encoder._corner_hash_index(r, cfg.table_size, torch.device("cpu"))
            corner = hash_tables[hash_pos[lvl]][idx].reshape(r + 1, r + 1, r + 1, -1)
            res = lerp
        axes = (0, 1, 2)
        if zcf:
            corner, axes = torch.movedim(corner, -1, 1), (0, 2, 3)
        for n, axis in zip(g.shape, axes):
            corner = res(corner, n, r, axis)
        outs.append(corner)
    return torch.cat(outs, dim=1 if zcf else -1)


@pytest.mark.parametrize("layout", ["zcf", "grid"])
@pytest.mark.parametrize("name", ["dense-mix", "hash-only"])
def test_deterministic_pullback_matches_the_index_add_one(name, layout):
    """The encoding and its pull-back against the index_add encoder they
    replace: float32 reorderings only (the resampling matmul adds the two
    weighted corners in its own order, with 1 - w rounded from float64;
    the gather-sum adds each entry's corners in another order), so rel-L2
    1e-6 and 1e-6 absolute on O(1) features, 1e-6 rel-L2 per table leaf."""
    cfg = CFGS[name]
    g = GridSpec(nx=37, ny=9, nz=6)
    _, tt = _tables(cfg, seed=9)
    fn = encoders.encode_grid_zcf if layout == "zcf" else encoders.encode_grid
    leaves = [x.clone().requires_grad_() for x in tree.leaves(tt)]
    leaves_old = [x.clone().requires_grad_() for x in tree.leaves(tt)]
    out = fn(cfg, tree.unflatten(tt, leaves), g)
    old = _index_add_encode_grid(cfg, tree.unflatten(tt, leaves_old), g, layout == "zcf")
    _close(out, old.detach().numpy())
    ct = torch.tensor(np.random.default_rng(2).standard_normal(tuple(out.shape)).astype(np.float32))
    for a, b in zip(torch.autograd.grad(out, leaves, ct), torch.autograd.grad(old, leaves_old, ct)):
        assert rel_l2_err(a.numpy(), b.numpy()) <= 1e-6


@pytest.mark.parametrize("name", ["dense-mix", "hash-only"])
def test_encode_grid_pullback_matches_jax_grad(name):
    """encode_grid (the [nz, ny, nx, LF] layout) and the gradient of a
    weighted sum of it against jax.grad of the same function of the JAX
    package's encode_grid: the forward at 1e-6, each table leaf at 1e-5."""
    cfg = CFGS[name]
    g = GridSpec(nx=40, ny=7, nz=5)
    jt, tt = _tables(cfg, seed=4)
    ct = np.random.default_rng(3).standard_normal(g.shape + (cfg.out_dim,)).astype(np.float32)
    ref = jax.grad(lambda t: jnp.sum(jenc.encode_grid(_jax(cfg), t, _jax(g)) * ct))(jt)
    leaves = [x.requires_grad_() for x in tree.leaves(tt)]
    out = encoders.encode_grid(cfg, tree.unflatten(tt, leaves), g)
    _close(out, jenc.encode_grid(_jax(cfg), jt, _jax(g)))
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(ct)), leaves)
    for a, b in zip(grads, jax.tree_util.tree_leaves(ref)):
        assert rel_l2_err(a.numpy(), np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("r, log2_t", [(4, 7), (8, 7), (24, 14), (40, 10)])
def test_inverse_table_covers_every_corner_once(r, log2_t):
    """Row e of the inverse table lists exactly the corners that hash to e,
    in ascending order, then the padding index (r+1)^3; together the rows
    hold every corner exactly once, and the widest row has no padding."""
    t = 1 << log2_t
    idx, inv = hash_encoder._corner_hash_index(r, t, torch.device("cpu"))
    idx, inv = idx.numpy(), inv.numpy()
    n = (r + 1) ** 3
    assert idx.shape == (n,) and inv.shape[0] == t
    real = inv[inv < n]
    np.testing.assert_array_equal(np.sort(real), np.arange(n))
    assert np.all(inv[inv >= n] == n)
    for e in np.unique(np.concatenate([idx[:50], idx[-50:]])):
        row = inv[e][inv[e] < n]
        np.testing.assert_array_equal(row, np.flatnonzero(idx == e))
        assert np.all(inv[e][len(row):] == n)
    assert (inv < n).sum(axis=1).max() == inv.shape[1]
    # the gather's backward is exactly that sum: one-hot cotangents land on their entries
    table = torch.zeros(t, 1, requires_grad=True)
    out = hash_encoder._hashed_corners(HashEncodingConfig(num_levels=1, features_per_level=1, log2_table_size=log2_t),
                                       table, r)
    ct = torch.arange(n, dtype=torch.float32).reshape(out.shape)
    (gt,) = torch.autograd.grad(out, table, ct)
    np.testing.assert_array_equal(gt[:, 0].numpy(), np.bincount(idx, weights=np.arange(n), minlength=t).astype(np.float32))


# ---------------------------------------------------------------------------
# The kernel pair's host tables (csrc/hash_encode.cu runs only on the card)
# ---------------------------------------------------------------------------

NGP_L16 = HashEncodingConfig(num_levels=16, base_resolution=16, max_resolution=256, log2_table_size=14,
                             dense_oversubscribed=True)  # portbench/configs/ngp_hash_l16.json
_KERNEL_RES = sorted({int(r) for c in (NGP_L16, NGPFieldConfig().encoding) for r in c.level_resolutions()})


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _check_axis_tables(m, fast):
    """_axis_tables(m) against m itself: the taps and the CSR lists put
    back into a matrix give m (bf16-rounded for fast) bit for bit, every
    nonzero once, each row's columns ascending."""
    want = hash_encoder._bf16(torch.from_numpy(m)).numpy() if fast else m
    i0, w, indptr, idx, wts = hash_encoder._axis_tables(m, fast)
    r1, n = m.shape
    taps = np.zeros_like(m)
    taps[i0, np.arange(n)] = w[:, 0]
    taps[i0 + 1, np.arange(n)] += w[:, 1]
    np.testing.assert_array_equal(_bits(taps), _bits(want))
    assert indptr[0] == 0 and indptr[-1] == len(idx) == np.count_nonzero(want)
    csr = np.zeros_like(m)
    for j in range(r1):
        cols = idx[indptr[j]:indptr[j + 1]]
        assert np.all(np.diff(cols) > 0)
        csr[j, cols] = wts[indptr[j]:indptr[j + 1]]
    np.testing.assert_array_equal(_bits(csr), _bits(want))
    assert np.all(wts != 0)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 96, 256])
def test_kernel_tables_reproduce_the_resampling_matrix(n, fast):
    """Every level resolution of ngp_hash_l16 and of NGPFieldConfig() at
    grid sizes 1, 7, 96 and 256: the forward's taps and the pull-back's
    ascending CSR lists hold exactly the nonzeros of _resample_matrix(n, r),
    the bits the plain matmuls multiply by."""
    for r in _KERNEL_RES:
        _check_axis_tables(hash_encoder._resample_matrix(n, r), fast)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("periodic", [True, False], ids=["wrapped", "clamped"])
def test_kernel_tables_of_halo_rows(periodic, fast):
    """The rows form's z tables: m[:, rows] for a shard's halo rows
    (mega_bwd.halo_rows, wrapped or clamped: rows repeat), column for
    column and nonzero for nonzero."""
    from phys_autodiff_tpu_torch.kernels import mega_bwd

    g = GridSpec(nx=8, ny=8, nz=12, periodic=periodic)
    rows = mega_bwd.halo_rows(g, 0, 4).tolist()
    assert rows[:3] == ([10, 11, 0] if periodic else [0, 0, 0]) and len(rows) == 8
    for r in _KERNEL_RES:
        _check_axis_tables(hash_encoder._resample_matrix(g.nz, r)[:, rows], fast)


@pytest.mark.parametrize("case", ["ngp_l16-ragged", "default-rows", "small-tiles"])
def test_kernel_plan_lays_out_every_level(case, monkeypatch):
    """_plan_arrays as the kernels read it: each level's taps at their
    offsets and its CSR lists at the offsets in meta give back the level's
    matrices; pass A's tiles cover each level's lattice rows once, read
    within their rows [y0, y1) and fit the shared memory asked for; pass
    B's tiles cover each level's (point block, lattice plane) once; the
    planes and gradients lie end to end."""
    from phys_autodiff_tpu_torch.kernels import mega_bwd

    cfg, (nx, ny, nz), rows = {
        "ngp_l16-ragged": (NGP_L16, (37, 9, 5), None),
        "default-rows": (NGPFieldConfig().encoding, (16, 12, 10), "halo"),
        "small-tiles": (ENC, (13, 7, 6), None),
    }[case]
    if case == "small-tiles":
        monkeypatch.setattr(hash_encoder, "_TILE_ROWS", 3)
        monkeypatch.setattr(hash_encoder, "_TILE_POINTS", 40)
        monkeypatch.setattr(hash_encoder, "_Z_TERMS", 2)
    if rows == "halo":
        rows = tuple(mega_bwd.halo_rows(GridSpec(nx=nx, ny=ny, nz=nz), 2, 3).tolist())
    res = tuple(int(r) for r in cfg.level_resolutions())
    a = hash_encoder._plan_arrays(res, nz, ny, nx, rows, False)
    nlev, k = len(res), a["k"]
    assert k == (nz if rows is None else len(rows))
    zoff, yoff, xoff = 0, nlev * k, nlev * (k + ny)
    plane = grad = 0
    for lvl, r in enumerate(res):
        r1 = r + 1
        meta = a["meta"][lvl]
        assert meta[0] == r and meta[4] == plane and meta[5] == grad
        mz = hash_encoder._resample_matrix(nz, r)
        mats = {"x": hash_encoder._resample_matrix(nx, r), "y": hash_encoder._resample_matrix(ny, r),
                "z": mz if rows is None else mz[:, list(rows)]}
        for a_name, base, n in (("z", zoff, k), ("y", yoff, ny), ("x", xoff, nx)):
            i0 = a["taps_i"][base + lvl * n: base + (lvl + 1) * n]
            w = a["taps_w"][base + lvl * n: base + (lvl + 1) * n]
            taps = np.zeros((r1, n), np.float32)
            taps[i0, np.arange(n)] = w[:, 0]
            taps[i0 + 1, np.arange(n)] += w[:, 1]
            np.testing.assert_array_equal(_bits(taps), _bits(mats[a_name]))
        for slot, a_name in ((1, "x"), (2, "y"), (3, "z")):
            ptr = a["cptr"][meta[slot]: meta[slot] + r1 + 1]
            csr = np.zeros_like(mats[a_name])
            for j in range(r1):
                csr[j, a["cidx"][ptr[j]:ptr[j + 1]]] = a["cw"][ptr[j]:ptr[j + 1]]
            np.testing.assert_array_equal(_bits(csr), _bits(mats[a_name]))
        covered = np.zeros(r1, int)
        for lv, ia, ib, y0, y1, *_ in a["tiles_a"].tolist():
            if lv != lvl:
                continue
            covered[ia:ib] += 1
            assert (ib - ia) * r1 <= hash_encoder._TILE_POINTS
            ys = np.flatnonzero(mats["y"][ia:ib].any(axis=0))
            assert (y0, y1) == ((ys[0], ys[-1] + 1) if len(ys) else (y0, y0))
        np.testing.assert_array_equal(covered, 1)
        cells = np.zeros((r1, r1 * r1), int)
        for lv, e0, iz0, iz1 in a["tiles_b"].tolist():
            if lv == lvl:
                cells[iz0:iz1, e0:e0 + 256] += 1
        np.testing.assert_array_equal(cells, 1)
        plane, grad = plane + 2 * r1 * r1, grad + 2 * r1 ** 3
    assert (a["row_floats"], a["grad_floats"]) == (plane, grad)
    q = 2 * (max(res) + 1) * hash_encoder._Q_STRIDE
    points = max((t[2] - t[1]) * (res[t[0]] + 1) for t in a["tiles_a"].tolist())
    assert a["smem_a"] == 4 * (2 * nx * hash_encoder._STAGE_STRIDE + q + q % 2) + 8 * points


def test_cpu_tables_take_the_plain_path():
    """CPU tables never reach the kernels: encode_grid_zcf and
    encode_grid_zcf_rows (and their pull-backs) are the plain ops bit for
    bit and leave the kernel pair's launch counters at 0; a device that is
    neither CPU nor CUDA raises."""
    from phys_autodiff_tpu_torch.kernels import _build, mega_bwd

    names = ("hash_encode", "hash_encode pullback", "hash_encode bf16", "hash_encode bf16 pullback")
    g = GridSpec(nx=13, ny=7, nz=6)
    rows = mega_bwd.halo_rows(g, 2, 2)
    _, tt = _tables(ENC, seed=2)
    for k in names:
        _build.LAUNCHES[k] = 0
    for fast in (False, True):
        leaves = [x.clone().requires_grad_() for x in tree.leaves(tt)]
        tab = tree.unflatten(tt, leaves)
        for out, plain in ((encoders.encode_grid_zcf(ENC, tab, g, fast=fast),
                            hash_encoder.encode_grid_zcf_plain(ENC, tab, g, fast)),
                           (encoders.encode_grid_zcf_rows(ENC, tab, g, rows, fast=fast),
                            hash_encoder.encode_grid_zcf_rows_plain(ENC, tab, g, rows, fast))):
            assert torch.equal(out, plain)
            ct = torch.ones_like(out)
            for a, b in zip(torch.autograd.grad(out, leaves, ct), torch.autograd.grad(plain, leaves, ct)):
                assert torch.equal(a, b)
    assert all(_build.LAUNCHES[k] == 0 for k in names)
    meta = tree.map_tree(lambda x: x.to("meta"), tt)
    with pytest.raises(ValueError, match="no hash encoder for device"):
        hash_encoder.encode_grid_zcf(ENC, meta, g)
