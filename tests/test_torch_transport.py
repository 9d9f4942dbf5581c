"""Semi-Lagrangian transport (phys_autodiff_tpu_torch/apps/transport.py) and
K8 (kernels/transport.py) against the JAX package's apps/transport.py and
pallas/transport.py.

The same numpy inputs go through both packages. On the CPU the port's K8
wrappers run the kernel's plain version (the roll+select step). Limits: the
JAX kernel contract, max abs 1e-6 a step (tests/test_transport_kernel.py:
39-40), 5e-6 over a 4-step rollout (:49-50); the Pallas kernels run in
interpret mode at that file's aligned 128x16x6 case; gradients at
GRAD_REL / GRAD_MAX (utils/tolerances.py); the bf16 tier in the 1e-2 class
(tests/test_transport.py:317-336).
"""

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.apps import transport as jtr
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.pallas import transport as jpk
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig
from phys_autodiff_tpu_torch.apps import transport as tr
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import transport as ktr
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.utils import tolerances as tol

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jtr)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(dims, periodic):
    return GridSpec(*dims, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=periodic)


GRIDS = [((16, 12, 8), True), ((16, 12, 8), False), ((13, 7, 5), True), ((13, 7, 5), False),
         ((9, 6, 1), True), ((9, 6, 1), False), ((9, 6, 2), True), ((9, 6, 2), False)]
IDS = [f"{d[0]}x{d[1]}x{d[2]}-{'periodic' if p else 'clamp'}" for d, p in GRIDS]
DT = 0.5  # velocities of order 1 (the batched step advects u itself), so 1e-6 is a few float32 ulps


def _case(g, seed=0, cfl=1.2):
    """sigma and a velocity whose offsets reach +-cfl cells (clipped past 1)."""
    rng = np.random.default_rng(seed)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (rng.uniform(-cfl, cfl, size=(3,) + g.shape)
         * np.array([g.hx, g.hy, g.hz])[:, None, None, None] / DT).astype(np.float32)
    return sigma, u


def _t(a):
    return torch.tensor(a)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


@functools.partial(jax.jit, static_argnums=0)
def _jax_steps(jg, sigma, u):
    """The JAX package's step, batched step, MacCormack steps (limited and
    not, single and batched), ring bounds and max CFL, in one program."""
    mac = [f(jg, x, u, DT, limit=limit) for limit in (True, False)
           for f, x in ((jtr.maccormack_step, sigma), (jtr.maccormack_step_many, u))]
    return (jtr.transport_step(jg, sigma, u, DT), jtr.transport_step_many(jg, u, u, DT), mac,
            jtr._ring_bounds(sigma, jg.periodic), jtr.max_cfl(jg, u, DT))


@pytest.mark.parametrize("dims,periodic", GRIDS, ids=IDS)
def test_step_many_maccormack_and_bounds_match_jax(dims, periodic):
    g = _grid(dims, periodic)
    sigma, u = _case(g)
    step, many_ref, mac_ref, (jlo, jhi), cfl = _jax_steps(_jax(g), sigma, u)
    _close(tr.transport_step(g, _t(sigma), _t(u), DT), step, 1e-6)
    # C = 3 (the Euler self-advection: the fields are u itself), bitwise per
    # channel against C = 1
    many = tr.transport_step_many(g, _t(u), _t(u), DT)
    for c in range(3):
        np.testing.assert_array_equal(many[c].numpy(), tr.transport_step(g, _t(u[c]), _t(u), DT).numpy())
    _close(many, many_ref, 1e-6)
    mac = [f(g, _t(x), _t(u), DT, limit=limit) for limit in (True, False)
           for f, x in ((tr.maccormack_step, sigma), (tr.maccormack_step_many, u))]
    for a, b in zip(mac, mac_ref):
        _close(a, b, 1e-6)
    lo, hi = tr._ring_bounds(_t(sigma), periodic)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_allclose(float(tr.max_cfl(g, _t(u), DT)), float(cfl), rtol=1e-6)


@pytest.mark.parametrize("scheme", ["semi_lagrangian", "maccormack"])
@pytest.mark.parametrize("periodic", [True, False])
def test_rollout_matches_jax(scheme, periodic):
    g = _grid((16, 12, 8), periodic)
    sigma, u = _case(g, seed=1, cfl=0.9)
    cfg = tr.TransportConfig(dt=DT, steps=4, scheme=scheme)
    out, cfl = tr.transport(g, _t(sigma), _t(u), cfg)
    ref, cfl_r = jtr.transport(_jax(g), jnp.asarray(sigma), jnp.asarray(u), _jax(cfg))
    _close(out, ref, 5e-6)
    np.testing.assert_allclose(float(cfl), float(cfl_r), rtol=1e-6)
    # the max principle
    assert float(out.max()) <= sigma.max() + 1e-6 and float(out.min()) >= sigma.min() - 1e-6


def test_time_dependent_from_a_model_matches_jax():
    g = _grid((16, 12, 8), True)
    cfg = MLPGridConfig(dims=MLPDims(H=8))
    params = mlp.init_params(cfg.dims, seed=4, scale=0.3, device="cpu")
    jparams = jmlp.init_params(_jax(cfg.dims), seed=4, scale=0.3)
    sigma = np.random.default_rng(5).normal(size=g.shape).astype(np.float32)
    tcfg = tr.TransportConfig(dt=0.02, steps=3, scheme="maccormack")
    out, cfl = tr.transport_time_dependent(g, _t(sigma), tr.velocity_grid_fn_from_model(g, cfg, params), 0.1,
                                           tcfg)
    ref, cfl_r = jtr.transport_time_dependent(_jax(g), jnp.asarray(sigma),
                                              jtr.velocity_grid_fn_from_model(_jax(g), _jax(cfg), jparams), 0.1,
                                              _jax(tcfg))
    _close(out, ref, 5e-6)
    np.testing.assert_allclose(float(cfl), float(cfl_r), rtol=1e-6)


def test_bf16_tier_tracks_the_f32_step_and_jax():
    g = _grid((16, 12, 8), True)
    rng = np.random.default_rng(3)
    sigma = rng.uniform(size=g.shape).astype(np.float32)
    u = (0.4 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    out = tr.transport_step_bf16(g, _t(sigma), _t(u), 0.1)
    assert out.dtype == torch.bfloat16
    ref = tr.transport_step(g, _t(sigma), _t(u), 0.1)
    err = float(torch.linalg.norm(out.float() - ref) / torch.linalg.norm(ref))
    assert err < 2e-2, err
    j = np.asarray(jtr.transport_step_bf16(_jax(g), sigma, u, 0.1).astype(jnp.float32))
    assert float(np.linalg.norm(out.float().numpy() - j) / np.linalg.norm(j)) < 2e-2
    zero = tr.transport_step_bf16(g, _t(sigma), torch.zeros((3,) + g.shape), 0.05)
    np.testing.assert_array_equal(zero.float().numpy(), _t(sigma).to(torch.bfloat16).float().numpy())


def _aligned_case(periodic):
    """tests/test_transport_kernel.py's _case: the TPU kernels' aligned grid."""
    g = GridSpec(nx=128, ny=16, nz=6, hx=0.5, hy=0.25, hz=0.125, dt=1e-3, periodic=periodic)
    rng = np.random.default_rng(6 + periodic)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (rng.uniform(-0.95, 0.95, size=(3,) + g.shape)
         * np.array([g.hx, g.hy, g.hz])[:, None, None, None] / 0.01).astype(np.float32)
    return g, sigma, u


@pytest.mark.parametrize("periodic", [True, False])
def test_plain_versions_match_the_pallas_kernels(periodic):
    """K8's plain version against transport_step_fused (both TPU pipelines)
    and K8c's against transport_step_fused_pre, in interpret mode."""
    _build.reset_launches()
    g, sigma, u = _aligned_case(periodic)
    jg = _jax(g)
    out = ktr.transport_step_plain(g, _t(sigma), _t(u), 0.01)
    for variant in ("slab", "plane"):
        _close(out, jpk.transport_step_fused(jg, sigma, u, 0.01, interpret=True, variant=variant), 1e-6)
    _close(ktr.transport_step_fused(g, _t(sigma), _t(u), 0.01), jpk.transport_step_fused(jg, sigma, u, 0.01,
                                                                                         interpret=True), 1e-6)
    weights = ktr.transport_weights(g, _t(u), 0.01)
    jweights = jpk.transport_weights(jg, jnp.asarray(u), 0.01)
    for w, jw in zip(weights, jweights):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    ref = jpk.transport_step_fused_pre(jg, sigma, jweights, interpret=True)
    _close(ktr.transport_pre_plain(g, _t(sigma), weights), ref, 1e-6)
    _close(ktr.transport_step_fused_pre(g, _t(sigma), weights), ref, 1e-6)
    assert _build.LAUNCHES["transport"] == 0 and _build.LAUNCHES["transport_pre"] == 0


@pytest.mark.parametrize("dims,periodic", [((13, 7, 5), False), ((9, 6, 2), True)])
def test_autograd_matches_jax_grad(dims, periodic):
    """The K8 autograd.Function (kernel forward, the plain version's VJP)
    against jax.grad of the JAX step, in sigma and u."""
    g = _grid(dims, periodic)
    sigma, u = _case(g, seed=2, cfl=0.9)
    wts = np.random.default_rng(7).normal(size=(2,) + g.shape).astype(np.float32)

    def jloss(s, v):
        out = jtr.transport_step_many(_jax(g), jnp.stack([s, v[0]]), v, DT)
        return jnp.sum(out * wts)

    js, ju = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(sigma), jnp.asarray(u))
    s_t, u_t = _t(sigma).requires_grad_(), _t(u).requires_grad_()
    out = tr.transport_step_many(g, torch.stack([s_t, u_t[0]]), u_t, DT)
    gs, gu = torch.autograd.grad(torch.sum(out * _t(wts)), [s_t, u_t])
    for x, y in ((gs, js), (gu, ju)):
        x, y = x.numpy(), np.asarray(y)
        assert np.linalg.norm(x - y) <= tol.GRAD_REL * np.linalg.norm(y)
        assert np.abs(x - y).max() <= tol.GRAD_MAX * max(1.0, np.abs(y).max())


def test_step_shapes_and_channels():
    g = _grid((9, 6, 2), True)
    sigma, u = _case(g)
    with pytest.raises(ValueError, match="u: expected shape"):
        ktr.transport_step_fused(g, _t(sigma), _t(u[:2]), DT)
    five = np.random.default_rng(1).normal(size=(5,) + g.shape).astype(np.float32)
    out = ktr.transport_step_many_fused(g, _t(five), _t(u), DT)  # two launches on the card (4 + 1)
    for c in range(5):
        np.testing.assert_array_equal(out[c].numpy(), ktr.transport_step_plain(g, _t(five[c]), _t(u), DT).numpy())
    with pytest.raises(ValueError, match="unknown transport scheme"):
        tr.make_step(g, tr.TransportConfig(scheme="rk4"))


@pytest.mark.parametrize("channels", [2, 4, 5])
@pytest.mark.parametrize("dims,periodic", [((13, 7, 5), False), ((16, 12, 8), True)])
def test_channels_match_jax(channels, dims, periodic):
    """The batched step at C = 2, 4 and 5 (two launches on the card)
    against the JAX package's transport_step_many, +dt and -dt."""
    g = _grid(dims, periodic)
    sigma, u = _case(g, seed=3)
    fields = np.concatenate([sigma[None], u, 0.5 * sigma[None]])[:channels]
    for dt in (DT, -DT):
        ref = jax.jit(jtr.transport_step_many, static_argnums=0)(_jax(g), fields, u, dt)
        _close(tr.transport_step_many(g, _t(fields), _t(u), dt), ref, 1e-6)


def _image(i, n, periodic):
    """ops/stencil.shift's image of index i on an axis of extent n."""
    return i % n if periodic else min(max(i, 0), n - 1)


# The chip edges of K8's walk (chip_smoke.py phase 3) and the flagship.
WALK_GRIDS = [(40, 9, 1), (40, 9, 2), (24, 13, 5), (7, 3, 11), (30, 9, 3), (33, 17, 5), (4, 8, 3), (36, 9, 40),
              (64, 16, 13), (1, 1, 1), (100, 1100, 2), (36, 300, 40), (33, 120, 60), (128, 96, 96)]


@pytest.mark.parametrize("dims", WALK_GRIDS, ids=[f"{d[0]}x{d[1]}x{d[2]}" for d in WALK_GRIDS])
def test_launch_geometry_covers_every_cell_once(dims):
    """The host's launch geometry (kernels/transport.launch_geometry and the
    kernel's block -> walk decode, block_walks) writes every output cell
    exactly once, and every plane, row and column a block reads lies in the
    grid or is its wrap / clamp image."""
    g = _grid(dims, True)
    zc, blocks = ktr.launch_geometry(*dims)
    walks = ktr.block_walks(g)
    tiles = -(-g.nx // ktr.TILE_X) * -(-g.ny // ktr.TILE_Y)
    assert len(walks) == blocks == tiles * -(-g.nz // zc)
    count = np.zeros(g.shape, np.int32)
    for x0, y0, z0, z1 in walks:
        assert 0 <= z0 < z1 <= min(z0 + zc, g.nz) and x0 < g.nx and y0 < g.ny
        count[z0:z1, y0:y0 + ktr.TILE_Y, x0:x0 + ktr.TILE_X] += 1
        for periodic in (True, False):
            for lo, hi, n in ((z0 - 1, z1, g.nz), (y0 - 1, y0 + ktr.TILE_Y, g.ny), (x0 - 1, x0 + ktr.TILE_X, g.nx)):
                for i in range(lo, hi + 1):
                    j = _image(i, n, periodic)
                    assert 0 <= j < n and (j == i or not 0 <= i < n)
    np.testing.assert_array_equal(count, 1)


def test_launch_geometry_fills_the_card_in_balanced_waves():
    """At the flagship one wave of equal walks (9 planes, 528 = 132 x 4
    blocks); at 256^3 one wave streaming z (128 planes, 512 blocks); a
    grid with more tiles than a wave takes the fewest waves for its cost."""
    assert ktr.launch_geometry(128, 96, 96) == (9, 528)
    assert ktr.launch_geometry(256, 256, 256) == (128, 512)
    wave = ktr.NUM_SMS * ktr.BLOCKS_PER_SM
    for dims in WALK_GRIDS:
        zc, blocks = ktr.launch_geometry(*dims)
        tiles = blocks // -(-dims[2] // zc)
        cost = -(-blocks // wave) * (zc + 2 + ktr.FILL_PLANES)
        for other in range(1, dims[2] + 1):
            assert cost <= -(-(tiles * -(-dims[2] // other)) // wave) * (other + 2 + ktr.FILL_PLANES)
