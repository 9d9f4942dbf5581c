"""K4, the backward mega-kernel (phys_autodiff_tpu_torch/kernels/mega_bwd.py),
vs the JAX kernel (pallas/mega_bwd.py, interpret mode), jax.value_and_grad
of the JAX staged loss, and the float64 gradient oracle (ref/f64_grad.py).

On the CPU the port runs the kernel's plain version: autograd through the
table MLP, the staged residuals and the fixed-order loss, pulled back
through the folds. Tolerances are those of tests/test_mega_bwd.py:52-58:
loss 5e-6 relative; gradients 1e-4 relative on the concatenation and 1e-3
per parameter; d_t 1e-3 (both sides are float32 programs of the same math
in different summation orders).
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
from phys_autodiff_tpu.pallas.mega_bwd import mega_loss_and_grad as jmega_lg
from phys_autodiff_tpu.ref.f64_grad import f64_loss_and_grad
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import mega_bwd as kb
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels import walk
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.models import mlp as tmlp

torch.set_num_threads(1)

GRID = dict(nx=128, ny=8, nz=6, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)


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


def _np(gp):
    return {k: v.detach().numpy() for k, v in gp.items()}


def _setup(h=32, seed=3, norm=CoordNorm.MinusOneToOne, **grid_kw):
    g = GridSpec(**{**GRID, **grid_kw})
    cfg = MLPGridConfig(dims=MLPDims(H=h), norm=norm)
    jp = jmlp.init_params(_jax(cfg.dims), seed=seed)
    return g, cfg, jp, tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _staged_value_and_grad(g, w, cfg):
    def staged(p, tt):
        return jops.total_loss(_jax(g), _jax(w), jgenerate(_jax(g), _jax(cfg), p, tt, g.dt))

    return jax.value_and_grad(staged, argnums=(0, 1))


def _staged_ref(g, w, cfg, jp, t):
    return _staged_value_and_grad(g, w, cfg)(jp, jnp.float32(t))


def _staged_ref_jit(g, w, cfg, jp, t):
    """_staged_ref compiled once (eager JAX compiles every op; the edge
    cases' grids and widths make that the test's main cost)."""
    return jax.jit(_staged_value_and_grad(g, w, cfg))(jp, jnp.float32(t))


def _agree(port, ref):
    (l, (gp, gt)), (l_ref, (gp_ref, gt_ref)) = port, ref
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < 5e-6
    gp = _np(gp)
    assert _rel(_cat(gp), _cat(gp_ref)) < 1e-4
    for k in gp_ref:
        assert _rel(gp[k], gp_ref[k]) < 1e-3, k
    assert abs(float(gt) - float(gt_ref)) / max(abs(float(gt_ref)), 1e-30) < 1e-3


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_mega_bwd_matches_jax_kernel_and_staged_grad(periodic, scheme):
    g, cfg, jp, tp = _setup(periodic=periodic, scheme=scheme)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    port = kb.mega_loss_and_grad(g, w, cfg, tp, 0.25)
    _agree(port, _staged_ref_jit(g, w, cfg, jp, 0.25))
    _agree(port, jmega_lg(_jax(g), _jax(w), _jax(cfg), jp, jnp.float32(0.25), "f32", True))


@pytest.mark.parametrize(
    "case, kw",
    [
        ("zero_to_one", dict(norm=CoordNorm.ZeroToOne, periodic=False)),
        ("h64", dict(h=64, seed=9)),
        ("ragged_clamp_upwind", dict(nx=24, ny=5, nz=3, periodic=False, scheme="upwind")),
        ("nz2_clamp", dict(nz=2, periodic=False)),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_mega_bwd_other_configs_match_staged_grad(case, kw):
    g, cfg, jp, tp = _setup(**kw)
    w = PhysWeights()
    _agree(kb.mega_loss_and_grad(g, w, cfg, tp, 0.4), _staged_ref(g, w, cfg, jp, 0.4))


def test_mega_bwd_scaled_weights():
    """The (2w/N) cotangent scales flow through for non-unit weights."""
    g, cfg, jp, tp = _setup(seed=11)
    w = PhysWeights(w_sigma=0.25, w_u=3.5)
    _agree(kb.mega_loss_and_grad(g, w, cfg, tp, 0.1), _staged_ref(g, w, cfg, jp, 0.1))


@pytest.mark.parametrize("scheme", ["central", "upwind"])
def test_mega_bwd_nz1_clamp_matches_staged_grad(scheme):
    """nz = 1 with clamp boundaries: the forward z difference is identically
    0, so its adjoint is 0. The JAX kernel's clamp z-edge legs get this case
    wrong (ROADMAP.md Queue C, R4: relative gradient errors near 2), so the
    port is held to jax.grad of the staged loss here, never to that kernel."""
    g, cfg, jp, tp = _setup(nz=1, periodic=False, scheme=scheme)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    _agree(kb.mega_loss_and_grad(g, w, cfg, tp, 0.25), _staged_ref(g, w, cfg, jp, 0.25))


def test_mega_bwd_against_the_f64_gradient_oracle():
    """Clamp, where the loss is small and gradient terms nearly cancel: the
    port's distance to the float64 truth is no worse than jax.grad's own
    (x1.5 slack for summation order, as tests/test_f64_adjudication.py)."""
    g, cfg, jp, tp = _setup(periodic=False, seed=777)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    l64, gp64 = f64_loss_and_grad(_jax(g), _jax(w), jp, 0.25)
    l32, (gp32, _) = _staged_ref(g, w, cfg, jp, 0.25)
    l, (gp, _) = kb.mega_loss_and_grad(g, w, cfg, tp, 0.25)
    assert abs(float(l) - l64) / abs(l64) <= max(5.0 * abs(float(l32) - l64) / abs(l64), 1e-6)
    gp = _np(gp)
    assert _rel(_cat(gp), _cat(gp64)) <= max(1.5 * _rel(_cat(gp32), _cat(gp64)), 1e-6)
    for k in gp64:
        assert _rel(gp[k], gp64[k]) <= max(2.0 * _rel(gp32[k], gp64[k]), 1e-6), k


def test_table_gradients_are_those_of_the_folded_loss():
    """The table-level plain version (what chip_smoke holds the kernel to)
    pulled back through the folds equals autograd of the whole staged
    table pipeline."""
    g, cfg, _, tp = _setup(periodic=False, scheme="upwind")
    w = PhysWeights()
    l, (gp, gt) = kb.mega_loss_and_grad_plain(g, w, cfg, tp, 0.3)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    t = torch.tensor(0.3, requires_grad=True)
    tables = kmlp.fold_tables(g, cfg, p, tfields.slice_times(t, g.dt))
    parts = kb.mega_partials_plain(g, *tables)
    ls, lu = kb.ops_loss.sum_partials(g, w, parts)
    (ls + lu).backward()
    assert float(l) == float((ls + lu).detach())
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), p[k].grad.numpy(), rtol=1e-6, atol=1e-9)
    assert abs(float(gt) - float(t.grad)) <= 1e-6 * abs(float(t.grad))


def test_gates_take_every_grid_and_bound_h_by_shared_memory():
    for kw in (dict(nx=7, ny=3, nz=1), dict(nx=1, ny=1, nz=1, periodic=False, scheme="upwind")):
        assert kb.mega_supported(GridSpec(**kw))
    g = GridSpec(**GRID)
    assert kb.mega_fits(g, 1) and kb.mega_fits(g, 128) and kb.mega_fits(g, 1300) and not kb.mega_fits(g, 1301)
    assert kb.smem_bytes(128) == 81920 and kb.smem_bytes(1300) + kb.SMEM_STATIC == 232000
    assert [kb.smem_bytes(h) for h in (1, 4, 5)] == [65536 + 512] * 2 + [65536 + 1024]
    with pytest.raises(ValueError, match="H <= 1300"):
        kb._check_gates(g, 1301)


@pytest.mark.parametrize(
    "dims, dab_slots",
    [((128, 96, 96), 311), ((40, 9, 1), 7), ((33, 9, 150), 267), ((7, 3, 11), 11), ((64, 16, 1100), 267)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_persistent_walk_deals_every_tile_row_to_one_block(dims, dab_slots):
    """The row partition of K4's and K6's passes (csrc/mlp_head.cuh): the
    tile rows (tile-major, z fastest) go to min(rows, 264) blocks in
    contiguous ranges of at least one row, each row to exactly one block;
    block_of_row finds that block; and the dAB slots b + T of the (block,
    tile) pairs are distinct and below dab_slots."""
    g = GridSpec(*dims, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    nrows = kb.num_tiles(g) * g.nz
    ranges = walk.block_ranges(g)
    assert len(ranges) == walk.num_blocks(g) == min(nrows, 264)
    assert ranges[0][0] == 0 and ranges[-1][1] == nrows
    assert all(r1 > r0 for r0, r1 in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    owner = [walk.block_of_row(r, nrows, len(ranges)) for r in range(nrows)]
    assert owner == [b for b, (r0, r1) in enumerate(ranges) for _ in range(r0, r1)]
    slots = [b + tile for b, (r0, r1) in enumerate(ranges) for tile in sorted({r // g.nz for r in range(r0, r1)})]
    assert len(set(slots)) == len(slots) and max(slots) < kb.dab_slots(g) == dab_slots


# The edges of the tiled MLP core that chip_smoke.py holds the kernel to on
# the card (its mlp_edges), all small: H 4, 33, 100, 200, 512 and the
# gate's top 1300; 33x9x150, 600 tile rows for 264 blocks; nx 7,
# 24, 33, 40 with ragged ny; nz 1, 2, 5, 9, 17; both schemes and both
# boundaries. The plain version is the referee there; here it is held to
# jax.grad of the JAX staged loss (no plane here is lane-aligned, so the JAX
# kernel refuses them all; at nz = 1 clamp the staged gradient is the right
# one, R4), at _agree's tolerances; and, on a lane-aligned 16x8x9 grid, to
# the JAX kernel in interpret mode as well.
MLP_EDGES = [
    ((40, 9, 1), True, "central", 4),
    ((7, 3, 9), False, "upwind", 33),
    ((24, 13, 17), True, "upwind", 100),
    ((33, 10, 2), False, "central", 200),
    ((40, 9, 5), True, "central", 512),
    ((33, 9, 150), False, "upwind", 128),
    ((24, 5, 3), True, "upwind", 1300),
    ((7, 3, 2), False, "central", 1300),
]


@pytest.mark.parametrize("dims, periodic, scheme, h", MLP_EDGES,
                         ids=[f"{d[0]}x{d[1]}x{d[2]}-{s}-{'periodic' if p else 'clamp'}-H{h}" for d, p, s, h in MLP_EDGES])
def test_plain_version_at_the_core_edges_matches_staged_grad(dims, periodic, scheme, h):
    g, cfg, jp, tp = _setup(h=h, seed=5, nx=dims[0], ny=dims[1], nz=dims[2], periodic=periodic, scheme=scheme)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    _agree(kb.mega_loss_and_grad_plain(g, w, cfg, tp, 0.25), _staged_ref_jit(g, w, cfg, jp, 0.25))


def test_plain_version_on_an_aligned_edge_matches_jax_kernel():
    g, cfg, jp, tp = _setup(h=33, seed=5, nx=16, ny=8, nz=9, periodic=False, scheme="upwind")
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    port = kb.mega_loss_and_grad_plain(g, w, cfg, tp, 0.25)
    _agree(port, jmega_lg(_jax(g), _jax(w), _jax(cfg), jp, jnp.float32(0.25), "f32", True))
    _agree(port, _staged_ref_jit(g, w, cfg, jp, 0.25))


def test_cpu_params_take_the_plain_version():
    _build.reset_launches()
    g, cfg, _, tp = _setup()
    kb.mega_loss_and_grad(g, PhysWeights(), cfg, tp, 0.25)
    assert _build.LAUNCHES["mega_bwd"] == 0

