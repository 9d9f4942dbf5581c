"""The pencil-decomposed FFT projection and diffusion
(phys_autodiff_tpu_torch/parallel/spectral.py) and the sharded Euler
rollout (apps/euler.rollout_sharded) on gloo groups of 2 and 4 CPU
processes, against the port's single-device projection, diffusion and
rollout and the JAX package's sharded functions on a mesh of the same size
(tests/conftest.py's CPU devices).

Ports the 8 tests of tests/test_spectral.py with their limits: the
projection 1e-6 relative L2 against the single device, the divergence down
by 2e-5, idempotence 1e-5, the diffusion 1e-6, both Euler rollouts 1e-5 with
max_abs_div <= 5e-5, an uneven z split rejected, and cfg.remat changing no
forward bit. Beside them, the gradient of a loss of the sharded rollout
(every rank's part, the backward on every rank) in the initial state:
within 1e-5 relative L2 of the single-device rollout's, and cfg.remat's
gradient the same to the bit. One gloo spawn a world size (the module fixture `gloo`) runs
every check on every rank and returns rank 0's results (rows gathered in z
order). The port against JAX is held to the same classes: both packages'
pencils evaluate the same transforms in the same factored order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from phys_autodiff_tpu.apps import euler as jeuler
from phys_autodiff_tpu.parallel import spectral as jspectral
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.apps import euler
from phys_autodiff_tpu_torch.ops import diagnostics, diffusion, projection
from phys_autodiff_tpu_torch.parallel import spectral
from phys_autodiff_tpu_torch.parallel.launch import run_gloo
from phys_autodiff_tpu_torch.parallel.mesh import shard_rows
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

SIZES = (2, 4)
ROLLOUTS = {
    # tests/test_spectral.py:59 (every stage) and :121 (MacCormack, confinement)
    "full": (5, dict(dt=0.05, steps=4, buoyancy=0.7, viscosity=0.05, diffusivity=0.02)),
    "maccormack": (7, dict(dt=0.05, steps=3, buoyancy=0.4, confinement=2.0, advection="maccormack")),
}
REMAT = (12, dict(dt=0.05, steps=3, buoyancy=0.7, advection="maccormack", confinement=1.0))


def _grid(nx=16, ny=16, nz=16):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.4, dt=1e-3)


def _rand_u(g, seed):
    return np.random.default_rng(seed).normal(size=(3,) + g.shape).astype(np.float32)


def _state(g, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=g.shape).astype(np.float32), (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32))


def _jgrid(g):
    return jconfig.GridSpec(**dataclasses.asdict(g))


def _jmesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("z",))


# ---------------------------------------------------------------------------
# The checks every gloo rank runs (results: rank 0's, rows gathered)
# ---------------------------------------------------------------------------


def _rank_checks(mesh):
    n = mesh.size
    out = {}

    def project(g, u):
        return mesh.all_gather(spectral.project_fft_sharded(g, shard_rows(mesh, torch.tensor(u), 1), mesh), 1)

    g = _grid()
    out["projection"] = project(g, _rand_u(g, 1)).numpy()
    gd = _grid(nx=12, ny=24, nz=8)
    out["divergence"] = project(gd, _rand_u(gd, 2)).numpy()
    once = project(g, _rand_u(g, 3))
    out["idempotent"] = (once.numpy(), project(g, once.numpy()).numpy())
    f = np.random.default_rng(6).normal(size=g.shape).astype(np.float32)
    diffuse = spectral.shard_local_diffuse_fft(g, mesh, 0.4, 0.1)
    out["diffusion"] = mesh.all_gather(diffuse(shard_rows(mesh, torch.tensor(f))), 0).numpy()
    for name, (seed, kw) in {**ROLLOUTS, "remat": REMAT}.items():
        sigma, u = _state(g, seed)
        s0 = euler.EulerState(shard_rows(mesh, torch.tensor(sigma)), shard_rows(mesh, torch.tensor(u), 1))
        runs = [euler.EulerConfig(**kw)] + ([euler.EulerConfig(remat=True, **kw)] if name == "remat" else [])
        res = []
        for cfg in runs:
            if cfg.remat:  # a gradient asked for, so that the steps are checkpointed
                s0 = euler.EulerState(s0.sigma.clone().requires_grad_(), s0.u.clone().requires_grad_())
            final, diag = euler.rollout_sharded(g, s0, cfg, mesh)
            res.append((mesh.all_gather(final.sigma.detach(), 0).numpy(), mesh.all_gather(final.u.detach(), 1).numpy(),
                        {k: v.detach().numpy() for k, v in diag.items()}))
        out[name] = res
    # nz (and, apart, ny) that does not divide over the ranks: raised on every rank before any collective
    rejected = []
    for gu in (GridSpec(nx=8, ny=8, nz=4 * n + 1, hx=0.5, hy=0.5, hz=0.5, dt=1e-3),
               GridSpec(nx=8, ny=4 * n + 1, nz=4 * n, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)):
        try:
            spectral.project_fft_sharded(gu, torch.zeros(3, 4, gu.ny, gu.nx), mesh)
            rejected.append(False)
        except ValueError:
            rejected.append(True)
    out["uneven"] = rejected
    # the gradient of sum(w_s * sigma) + sum(w_u * u) of the final state, with and without remat
    for name, (seed, kw) in ROLLOUTS.items():
        sigma, u = _state(g, seed)
        ws, wu = _loss_weights(g)
        grads = []
        for remat in (False, True):
            s0 = shard_rows(mesh, torch.tensor(sigma)).requires_grad_()
            u0 = shard_rows(mesh, torch.tensor(u), 1).requires_grad_()
            final, _ = euler.rollout_sharded(g, euler.EulerState(s0, u0), euler.EulerConfig(remat=remat, **kw), mesh)
            loss = torch.sum(shard_rows(mesh, ws) * final.sigma) + torch.sum(shard_rows(mesh, wu, 1) * final.u)
            gs, gu = torch.autograd.grad(loss, (s0, u0))
            grads.append((mesh.all_gather(gs, 0).numpy(), mesh.all_gather(gu, 1).numpy()))
        out[f"grad/{name}"] = grads
    return out


def _loss_weights(g):
    rng = np.random.default_rng(30)
    return torch.tensor(rng.normal(size=g.shape).astype(np.float32)), torch.tensor(
        rng.normal(size=(3,) + g.shape).astype(np.float32))


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def gloo(request):
    """(world size, rank 0's results of _rank_checks on a gloo group)."""
    n = request.param
    return n, run_gloo(_rank_checks, n)[0]


def _jax_project(g, u, n):
    return np.asarray(jspectral.project_fft_sharded(_jgrid(g), jnp.asarray(u), _jmesh(n)))


# ---------------------------------------------------------------------------
# tests/test_spectral.py
# ---------------------------------------------------------------------------


def test_sharded_projection_matches_single_chip(gloo):
    n, res = gloo
    g = _grid()
    u = _rand_u(g, 1)
    assert rel_l2_err(res["projection"], projection.project_fft(g, torch.tensor(u)).numpy()) <= 1e-6
    assert rel_l2_err(res["projection"], _jax_project(g, u, n)) <= 1e-6


def test_sharded_projection_kills_divergence(gloo):
    _, res = gloo
    g = _grid(nx=12, ny=24, nz=8)  # ny and nz divide over the ranks; x not a power of two
    u = torch.tensor(_rand_u(g, 2))
    before = float(torch.max(torch.abs(diagnostics.divergence(g, u))))
    after = float(torch.max(torch.abs(diagnostics.divergence(g, torch.tensor(res["divergence"])))))
    assert after <= 2e-5 * before, (before, after)


def test_sharded_projection_idempotent(gloo):
    _, res = gloo
    once, twice = res["idempotent"]
    assert rel_l2_err(twice, once) <= 1e-5


def test_sharded_diffusion_matches_single_chip(gloo):
    n, res = gloo
    g = _grid()
    f = np.random.default_rng(6).normal(size=g.shape).astype(np.float32)
    assert rel_l2_err(res["diffusion"], diffusion.diffuse_fft(g, torch.tensor(f), 0.4, 0.1).numpy()) <= 1e-6
    mesh = _jmesh(n)
    fn = jax.shard_map(jspectral.shard_local_diffuse_fft(_jgrid(g), n, 0.4, 0.1), mesh=mesh, in_specs=P("z"),
                       out_specs=P("z"), check_vma=False)
    ref = np.asarray(jax.jit(fn)(jax.device_put(jnp.asarray(f), NamedSharding(mesh, P("z")))))
    assert rel_l2_err(res["diffusion"], ref) <= 1e-6


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_sharded_euler_rollout_matches_single_chip(gloo, name):
    """The sharded rollout (K8's slab form, the pencil projection and
    diffusion, the halo-differenced confinement) against the single-device
    rollout and JAX's rollout_sharded: 1e-5 on the state, the kinetic
    energy and the max CFL; the divergence at rounding."""
    n, res = gloo
    g = _grid()
    seed, kw = ROLLOUTS[name]
    sigma, u = _state(g, seed)
    f1, d1 = euler.rollout(g, euler.EulerState(torch.tensor(sigma), torch.tensor(u)), euler.EulerConfig(**kw))
    fs, us, ds = res[name][0]
    assert rel_l2_err(fs, f1.sigma.numpy()) <= 1e-5
    assert rel_l2_err(us, f1.u.numpy()) <= 1e-5
    np.testing.assert_allclose(ds["kinetic_energy"], d1["kinetic_energy"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(ds["max_cfl"], d1["max_cfl"].numpy(), rtol=1e-5)
    assert float(np.max(ds["max_abs_div"])) <= 5e-5
    jf, jd = jeuler.rollout_sharded(_jgrid(g), jeuler.EulerState(jnp.asarray(sigma), jnp.asarray(u)),
                                    jeuler.EulerConfig(**kw), _jmesh(n))
    assert rel_l2_err(fs, np.asarray(jf.sigma)) <= 1e-5
    assert rel_l2_err(us, np.asarray(jf.u)) <= 1e-5
    np.testing.assert_allclose(ds["kinetic_energy"], np.asarray(jd["kinetic_energy"]), rtol=1e-5)


def test_sharded_projection_uneven_split_rejected(gloo):
    """nz (or ny) not divisible by the ranks raises ValueError on every rank
    before any collective, as the JAX package asserts."""
    n, res = gloo
    assert res["uneven"] == [True, True]
    g = GridSpec(nx=8, ny=8, nz=4 * n + 1, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    with pytest.raises(AssertionError):
        jspectral.project_fft_sharded(_jgrid(g), jnp.zeros((3,) + g.shape), _jmesh(n))


def test_sharded_remat_rollout_bitwise_matches_plain_sharded(gloo):
    """cfg.remat (each step checkpointed, as a gradient is asked for)
    changes no forward bit of the sharded rollout."""
    _, res = gloo
    (s1, u1, d1), (s2, u2, d2) = res["remat"]
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(d1["kinetic_energy"], d2["kinetic_energy"])


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_sharded_euler_rollout_gradient_matches_single_chip(gloo, name):
    """The gradient through the sharded rollout (K8's slab step's VJP, the
    halos' and the pencil all-to-alls' adjoints, which send the cotangents
    back across the ranks) in the initial sigma and u: within 1e-5 relative
    L2 of the single-device rollout's; with cfg.remat the same to the bit."""
    _, res = gloo
    g = _grid()
    seed, kw = ROLLOUTS[name]
    sigma, u = _state(g, seed)
    s0, u0 = torch.tensor(sigma).requires_grad_(), torch.tensor(u).requires_grad_()
    final, _ = euler.rollout(g, euler.EulerState(s0, u0), euler.EulerConfig(**kw))
    ws, wu = _loss_weights(g)
    want = torch.autograd.grad(torch.sum(ws * final.sigma) + torch.sum(wu * final.u), (s0, u0))
    (gs, gu), (rs, ru) = res[f"grad/{name}"]
    assert rel_l2_err(gs, want[0].numpy()) <= 1e-5, rel_l2_err(gs, want[0].numpy())
    assert rel_l2_err(gu, want[1].numpy()) <= 1e-5, rel_l2_err(gu, want[1].numpy())
    np.testing.assert_array_equal(rs, gs)
    np.testing.assert_array_equal(ru, gu)
