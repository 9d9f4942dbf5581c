"""K3 (phys_autodiff_tpu_torch/kernels/mega.py) vs the JAX mega-kernel and
the JAX staged pipeline (the grid of tests/test_mega.py:21).

On the CPU the port runs the kernel's plain version (table MLP -> staged
residuals -> plane partials -> fixed-order sum); the JAX mega-kernel runs
in interpret mode. Tolerance 1e-5 relative, as tests/test_mega.py holds
mega against staged (the MLP's summation order differs between arms).
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
from phys_autodiff_tpu.pallas.mega import mega_loss_pipeline as jmega
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import mega as kmega
from phys_autodiff_tpu_torch.kernels import mega_bwd as kb
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.kernels import walk
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.models.fields import slice_times

torch.set_num_threads(1)

GRID = dict(nx=128, ny=8, nz=6, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    fields = {f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return getattr(jconfig, type(x).__name__)(**fields)


def _setup(h=32, norm=CoordNorm.MinusOneToOne, seed=3, **grid_kw):
    g = GridSpec(**{**GRID, **grid_kw})
    cfg = MLPGridConfig(dims=MLPDims(H=h), norm=norm)
    jp = jmlp.init_params(_jax(cfg.dims), seed=seed)
    tp = tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return g, cfg, jp, tp


def _staged(g, cfg, jp, t):
    return jops.loss_forward(_jax(g), _jax(W), jgenerate(_jax(g), _jax(cfg), jp, t, g.dt))


def _agree(port, ref, rel=1e-5):
    for a, b in zip(port, ref):
        assert abs(float(a) - float(b)) <= rel * abs(float(b)), (float(a), float(b))


@pytest.mark.parametrize(
    "periodic, scheme", [(True, "central"), (False, "upwind")], ids=["periodic-central", "clamp-upwind"]
)
def test_mega_matches_pallas_mega(periodic, scheme):
    g, cfg, jp, tp = _setup(periodic=periodic, scheme=scheme)
    port = kmega.mega_loss_pipeline(g, W, cfg, tp, 0.25)
    _agree(port, jmega(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.25), "f32", True))


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_mega_matches_staged_pipeline(periodic, scheme):
    g, cfg, jp, tp = _setup(periodic=periodic, scheme=scheme)
    _agree(kmega.mega_loss_pipeline(g, W, cfg, tp, 0.25), _staged(g, cfg, jp, 0.25))


@pytest.mark.parametrize(
    "case, kw",
    [
        ("zero_to_one", dict(norm=CoordNorm.ZeroToOne)),
        ("nz1", dict(nz=1)),
        ("h64", dict(h=64)),
        ("unaligned", dict(nx=24, ny=5, nz=3, periodic=False)),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_mega_on_other_configs_matches_staged(case, kw):
    g, cfg, jp, tp = _setup(**kw)
    _agree(kmega.mega_loss_pipeline(g, W, cfg, tp, 0.3), _staged(g, cfg, jp, 0.3))


def test_mega_equals_its_two_kernel_composition():
    """The mega plain version is K2's plain version followed by K1's loss
    partials with the same fixed-order sum: equal to the float."""
    g, cfg, _, tp = _setup(scheme="upwind")
    mega = kmega.mega_loss_pipeline(g, W, cfg, tp, 0.25)
    two = kres.loss_forward_fused(g, W, kmlp.generate_fields_fused(g, cfg, tp, 0.25))
    assert float(mega[0]) == float(two[0]) and float(mega[1]) == float(two[1])


# ---------------------------------------------------------------------------
# The redesigned kernel's host-side pieces and its plain version at the edges
# that chip_smoke.py holds the kernel to on the card
# ---------------------------------------------------------------------------

# chip_smoke.py's mlp_edges with K3's gate top (H = 1908): hidden-unit
# padding (H 4, 33, 100, 200, 512), tile columns and rows (nx 7-40, ragged
# ny), chunks and runs (nz 1, 2, 5, 9, 17; 33x9x150 has 600 tile rows for
# 264 blocks, so blocks share tiles and runs end inside a block), both
# schemes and both boundaries.
K3_EDGES = [
    ((40, 9, 1), True, "central", 4),
    ((7, 3, 9), False, "upwind", 33),
    ((24, 13, 17), True, "upwind", 100),
    ((33, 10, 2), False, "central", 200),
    ((40, 9, 5), True, "central", 512),
    ((33, 9, 150), False, "upwind", 128),
    ((24, 5, 3), True, "upwind", 1908),
    ((7, 3, 2), False, "central", 1908),
]


def _staged_jit(g, cfg):
    """The JAX staged loss, compiled once (eager JAX compiles every op; at
    these widths that is the test's main cost)."""

    def staged(p, t):
        return jnp.stack(jops.loss_forward(_jax(g), _jax(W), jgenerate(_jax(g), _jax(cfg), p, t, g.dt)))

    return jax.jit(staged)


@pytest.mark.parametrize("dims, periodic, scheme, h", K3_EDGES,
                         ids=[f"{d[0]}x{d[1]}x{d[2]}-{s}-{'periodic' if p else 'clamp'}-H{h}"
                              for d, p, s, h in K3_EDGES])
def test_plain_partials_at_the_edges_match_jax_staged_loss(dims, periodic, scheme, h):
    """mega_partials_plain -> sum_partials (what the kernel is held to on
    the card) against the JAX staged loss: 1e-5 relative, as
    tests/test_mega.py holds the mega arm to the staged one (the MLP sums
    in another order)."""
    g, cfg, jp, tp = _setup(h=h, seed=5, nx=dims[0], ny=dims[1], nz=dims[2], periodic=periodic, scheme=scheme)
    tables = kmlp.fold_tables(g, cfg, tp, slice_times(0.25, g.dt))
    port = kmega.ops_loss.sum_partials(g, W, kmega.mega_partials_plain(g, *tables))
    _agree(port, np.asarray(_staged_jit(g, cfg)(jp, jnp.float32(0.25))))


@pytest.mark.parametrize("nz, h, periodic, scheme", [(1, 4, False, "upwind"), (9, 33, True, "upwind"),
                                                     (17, 200, False, "central")],
                         ids=["nz1-H4-clamp-upwind", "nz9-H33-periodic-upwind", "nz17-H200-clamp-central"])
def test_plain_partials_on_aligned_edges_match_pallas_mega(nz, h, periodic, scheme):
    """On nx = 128 planes the JAX mega-kernel takes the shape: it runs in
    interpret mode, and the port's plain version agrees at 1e-5."""
    g, cfg, jp, tp = _setup(h=h, seed=5, nz=nz, periodic=periodic, scheme=scheme)
    tables = kmlp.fold_tables(g, cfg, tp, slice_times(0.25, g.dt))
    port = kmega.ops_loss.sum_partials(g, W, kmega.mega_partials_plain(g, *tables))
    _agree(port, jmega(_jax(g), _jax(W), _jax(cfg), jp, jnp.float32(0.25), "f32", True))


def test_gate_takes_every_h_that_k4_takes_and_raises_above():
    """K3's shared memory (csrc/mega.cu) bounds H at 1908; it takes every H
    that K4 takes, since make_fused_loss pairs the two."""
    g = GridSpec(**GRID)
    assert all(kmega.mega_fwd_fits(g, h) for h in range(1, 1909))
    assert not kmega.mega_fwd_fits(g, 1909) and not kmega.mega_fwd_fits(g, 0)
    assert all(kmega.mega_fwd_fits(g, h) for h in range(1, 1301) if kb.mega_fits(g, h))
    assert kmega.smem_bytes(128) == 49024 + 96 * 128
    assert kmega.smem_bytes(1908) + kmega.SMEM_STATIC <= kmega.SMEM_LIMIT < kmega.smem_bytes(1909) + kmega.SMEM_STATIC
    with pytest.raises(ValueError, match=r"K3: H=1909 .*H <= 1908"):
        kmega._check_gate(g, 1909)


def _tile_runs(g):
    """The runs of each block: (tile, za, zb) for the rows za .. zb - 1 of
    one tile in the block's range, in walk order."""
    runs = []
    for r0, r1 in walk.block_ranges(g):
        own, r = [], r0
        while r < r1:
            tile, za = divmod(r, g.nz)
            zb = min(g.nz, za + r1 - r)
            own.append((tile, za, zb))
            r += zb - za
        runs.append(own)
    return runs


def _k3_schedule(g):
    """A model of k_mega's walk (csrc/mega.cu): for each chunk of each
    block, the rows whose fields it evaluates at the tile's cells (three
    slices), the outer rows of the run it evaluates (t slice), the rows whose
    residual it finishes, and the window and t -+ dt ring slots it touches."""
    nslot, nlh = kmega.ZROWS + 3, kmega.ZROWS + 1
    out = []
    for r0, r1 in walk.block_ranges(g):
        r, za = r0, 0
        while r < r1:
            tile, z0 = divmod(r, g.nz)
            n = min(kmega.ZROWS, g.nz - z0, r1 - r)
            first, last = r == r0 or z0 == 0, r + n == r1 or z0 + n == g.nz
            za = z0 if first else za
            outer = ([z0 - 1] if first else []) + ([z0 + n] if last else [])
            done = list(range(z0 if first else z0 - 1, z0 + n if last else z0 + n - 1))
            window = {z: (z - za + 1) % nslot for z in range(z0 - 2, z0 + n + 1) if z >= za - 1}
            lohi = {z: (z - za + 1) % nlh for z in range(z0 - 1, z0 + n) if z >= za}
            out.append((tile, list(range(z0, z0 + n)), outer, done, window, lohi))
            r += n
    return out


@pytest.mark.parametrize("dims", [(128, 96, 96), (40, 9, 1), (33, 9, 150), (7, 3, 11), (24, 13, 17)],
                         ids=lambda d: "x".join(map(str, d)))
def test_runs_and_the_z_carry_cover_every_row_once(dims):
    """The runs of one tile in each block's range tile the walk; K3 evaluates every (tile, z) row's fields once, the two outer
    rows of each run once more (the z halo: 2 rows a run), and finishes
    every row's residual exactly once; within a chunk the rows it reads
    (z0 - 2 .. z0 + n) sit in distinct window slots and the rows whose
    t -+ dt it holds (z0 - 1 .. z0 + n - 1) in distinct ring slots."""
    g = GridSpec(*dims)
    ntiles = kres.num_tiles(g)
    runs = _tile_runs(g)
    for (r0, r1), own in zip(walk.block_ranges(g), runs):
        assert [t * g.nz + z for t, za, zb in own for z in range(za, zb)] == list(range(r0, r1))
        assert all(zb > za for _, za, zb in own) and len({t for t, _, _ in own}) == len(own)
    sched = _k3_schedule(g)
    fields = [(t, z) for t, rows, *_ in sched for z in rows]
    done = [(t, z) for t, _, _, rows, *_ in sched for z in rows]
    every = [(t, z) for t in range(ntiles) for z in range(g.nz)]
    assert sorted(fields) == every and sorted(done) == every
    assert sum(len(outer) for _, _, outer, *_ in sched) == 2 * sum(len(own) for own in runs)
    for _, rows, outer, _, window, lohi in sched:
        assert len(set(window.values())) == len(window) and len(set(lohi.values())) == len(lohi)
        assert set(rows) | set(outer) <= set(window)
    if dims == (128, 96, 96):
        assert max(len(own) for own in runs) == 2 and sum(len(own) for own in runs) == 288


def test_cpu_params_take_the_plain_version():
    _build.reset_launches()
    g, cfg, _, tp = _setup()
    kmega.mega_loss_pipeline(g, W, cfg, tp, 0.25)
    assert _build.LAUNCHES["mega"] == 0
