"""The z-sharded apps of the port on gloo groups of 2 and 4 CPU processes:
transport_sharded and the shard-local steps (K8's slab form; its plain twin
here), the ring bounds against a halo, advect_sharded, the differentiable
halo extension and the masked Euler rollout on the shards (the masked CGNR
projection), against the port's single-device functions and the JAX
package's sharded functions on a mesh of the same size
(tests/conftest.py's CPU devices).

Ports tests/test_transport.py:151 and :269 (the sharded rollouts bitwise
the single-device ones, both boundaries) and tests/test_sample_advect.py:
272 (advect_sharded bitwise advect, with no collective). One gloo spawn a
world size (the module fixture `gloo`) runs every check on every rank and
returns rank 0's results (rows gathered in z order). Limits: the port
against itself bitwise; the port against JAX at tests/test_torch_transport
.py's class, 5e-6 max abs over a rollout of up to 5 steps (two packages'
float32 steps round their offsets differently); the masked rollout 1e-9
relative L2 against the single-device masked rollout, both run in float64
on the dry run's phase 10 case (random u: in float32 a 20-iteration CGNR's
iterates on such a rough field part under any change in the order of its
sums, while in float64 the same iterations agree to about 1e-12, so the
comparison holds the sharded operator, its transpose and the distributed
sums to the single-device ones); and in float32, on
tests/test_torch_euler.py's smooth obstacle case, against JAX's masked
rollout on a mesh of the same size at that file's 1e-4 class.

Gradients: every check runs the backward on every rank of a loss that is
the sum of the ranks' parts, and holds the gathered gradient against the
single-device one (relative L2): the sharded transport 1e-5 in float32, the
masked rollout 1e-7 in float64. The masked rollout's backward solves CGNR's
normal equations for a cotangent with a part outside their range, so its 20
iterations amplify the order of the sums: the two gradients part by about
4e-9 where the states agree to 5e-13, while a dropped cross-rank term (A^T's
VJP, the fluid mean's sum) parts them by 5e-3 or more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from phys_autodiff_tpu.apps import euler as jeu
from phys_autodiff_tpu.apps import transport as jtr
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPGridConfig
from phys_autodiff_tpu_torch.apps import advect as adv
from phys_autodiff_tpu_torch.apps import euler
from phys_autodiff_tpu_torch.apps import transport as tr
from phys_autodiff_tpu_torch.kernels import transport as ktr
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.ops import obstacles
from phys_autodiff_tpu_torch.ops.stencil import z_rows
from phys_autodiff_tpu_torch.parallel import sharded as sh
from phys_autodiff_tpu_torch.parallel.launch import run_gloo
from phys_autodiff_tpu_torch.parallel.mesh import shard_rows
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

SIZES = (2, 4)
BOUNDARIES = {"periodic": True, "clamp": False}
#: A rollout of up to 5 steps against the JAX package (tests/test_torch_transport.py).
JAX_ROLLOUT_ATOL = 5e-6


def _grid(periodic):
    """tests/test_transport.py:153's grid."""
    return GridSpec(nx=8, ny=6, nz=16, hx=0.5, hy=0.25, hz=0.125, dt=1e-3, periodic=periodic)


def _case(g, seed):
    """tests/test_transport.py:155-161's sigma and velocity (offsets up to
    0.9 cells at dt = 0.01)."""
    rng = np.random.default_rng(seed)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (rng.uniform(-0.9, 0.9, size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None]
         / 0.01).astype(np.float32)
    return sigma, u


ROLLOUTS = {"semi_lagrangian": (9, 5), "maccormack": (21, 4)}  # scheme: (seed base, steps), as the JAX tests


def _advect_case():
    """tests/test_sample_advect.py:272-283's particles and model."""
    g = GridSpec(nx=16, ny=12, nz=8, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    cfg = MLPGridConfig()
    params = mlp.init_params(cfg.dims, seed=11, scale=0.3, device="cpu")
    pts0 = np.random.default_rng(4).uniform(0, [g.nx, g.ny, g.nz], size=(16, 3)).astype(np.float32)
    return g, adv.velocity_fn_from_model(g, cfg, params), torch.tensor(pts0), adv.AdvectConfig(steps=15, dt=1e-2)


def _masked_case(periodic):
    """The JAX dry run's phase 10 (__graft_entry__.py:287-332) at nz 8, in
    float64."""
    g = GridSpec(nx=16, ny=8, nz=8, hx=0.4, hy=0.4, hz=0.4, dt=1e-2, periodic=periodic)
    mask = obstacles.box_mask(g, (2, 2, 4), (6, 6, 12), device="cpu")
    rate, force = torch.zeros(g.shape), torch.zeros((3,) + g.shape)
    rate[1, 1:4, 1:4] = 2.0
    force[2, 1, 1:4, 1:4] = 0.5
    rng = np.random.default_rng(10)
    state = euler.EulerState(torch.tensor(np.abs(rng.normal(size=g.shape)).astype(np.float32)),
                             0.3 * torch.tensor(rng.normal(size=(3,) + g.shape).astype(np.float32)))
    cfg = euler.EulerConfig(dt=0.05, steps=3, buoyancy=1.0, cg_maxiter=20)
    f64 = torch.float64
    return (g, mask.to(f64), euler.EulerSource(rate.to(f64), force.to(f64)),
            euler.EulerState(state.sigma.to(f64), state.u.to(f64)), cfg)


def _smooth_u(g, seed=0, scale=1.0):
    """tests/test_torch_euler.py's _smooth_u: a product of low sines per component."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij")
    comps = []
    for _ in range(3):
        kx, ky, kz = rng.integers(1, 3, size=3)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        comps.append((np.sin(2 * np.pi * kx * x / g.nx + ph[0]) * np.sin(2 * np.pi * ky * y / g.ny + ph[1])
                      * np.sin(2 * np.pi * kz * z / g.nz + ph[2])).astype(np.float32))
    return (np.stack(comps) * scale).astype(np.float32)


def _obstacle_case(periodic):
    """tests/test_torch_euler.py's test_rollout_with_an_obstacle_and_sources
    _matches_jax in float32: its grid, solid box, emitter, fan, smooth u and
    config (MacCormack, 20 CG iterations). Its clamped case adds viscosity,
    which the sharded rollout solves only on a periodic grid, so here the
    clamped case runs without it (and the periodic case had none)."""
    g = GridSpec(nx=16, ny=12, nz=8, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=periodic)
    mask = obstacles.box_mask(g, (2, 3, 4), (5, 7, 9), device="cpu")
    rate = np.zeros(g.shape, np.float32)
    rate[1:6, 2:8, 3:10] = 2.0
    force = np.zeros((3,) + g.shape, np.float32)
    force[0, 1:6, 2:8, 9:14] = 3.0
    sigma = np.abs(np.random.default_rng(4).normal(size=g.shape)).astype(np.float32)
    cfg = euler.EulerConfig(dt=0.05, steps=4, buoyancy=0.5, cg_maxiter=20, advection="maccormack")
    return g, mask, rate, force, sigma, _smooth_u(g, 5, 0.3), cfg


def _weights(shape, seed, dtype=torch.float32):
    """The fixed weights of a linear loss sum(w * out)."""
    return torch.tensor(np.random.default_rng(seed).normal(size=shape)).to(dtype)


def _single_grad(run, inputs, weights):
    """The gradient of sum_i sum(w_i * out_i) of run(*inputs) in every input."""
    leaves = [x.clone().requires_grad_() for x in inputs]
    outs = run(*leaves)
    loss = sum(torch.sum(w * o) for w, o in zip(weights, outs))
    return [x.numpy() for x in torch.autograd.grad(loss, leaves)]


def _sharded_grad(mesh, run, inputs, weights):
    """_single_grad on the shards: each rank's rows of the inputs and the
    weights (z on the last-but-two axis), its part of the loss, the backward
    on every rank, the rows of the gradients gathered in z order."""
    leaves = [shard_rows(mesh, x, x.ndim - 3).clone().requires_grad_() for x in inputs]
    outs = run(*leaves)
    loss = sum(torch.sum(shard_rows(mesh, w, w.ndim - 3) * o) for w, o in zip(weights, outs))
    return [mesh.all_gather(gr, gr.ndim - 3).numpy() for gr in torch.autograd.grad(loss, leaves)]


# ---------------------------------------------------------------------------
# The checks every gloo rank runs (results: rank 0's, rows gathered)
# ---------------------------------------------------------------------------


def _rank_checks(mesh):
    out = {}
    for name, per in BOUNDARIES.items():
        g = _grid(per)
        for scheme, (seed, steps) in ROLLOUTS.items():
            sigma, u = (torch.tensor(a) for a in _case(g, seed + per))
            got, cfl = tr.transport_sharded(g, shard_rows(mesh, sigma), shard_rows(mesh, u, 1),
                                            tr.TransportConfig(dt=0.01, steps=steps, scheme=scheme), mesh)
            out[f"rollout/{scheme}/{name}"] = (mesh.all_gather(got, 0).numpy(), float(cfl))
        # the batched shard-local steps against the per-channel ones, u itself and three other scalars
        sigma, u = (torch.tensor(a) for a in _case(g, 40 + per))
        ul = shard_rows(mesh, u, 1)
        fields = torch.stack([shard_rows(mesh, sigma), ul[0], ul[1]])
        for scheme in ROLLOUTS:
            cfg = tr.TransportConfig(scheme=scheme)
            many, one = tr.make_shard_local_step_many(g, cfg, mesh), tr.make_shard_local_step(g, cfg, mesh)
            for what, fs in (("self", ul), ("three", fields)):
                batched = many(fs, ul, 0.01)
                per_channel = torch.stack([one(fs[c], ul, 0.01) for c in range(fs.shape[0])])
                out[f"many/{scheme}/{what}/{name}"] = (mesh.all_gather(batched, 1).numpy(),
                                                       mesh.all_gather(per_channel, 1).numpy())
        # the ring bounds against the halo: exchanged here, and from a given extended slab
        sl = shard_rows(mesh, sigma)
        lo, hi = tr._ring_bounds_halo_z(mesh, sl[None], per, (3, 2), 1)
        f_ext = sh._halo_extend_z(mesh, sl, per, 0)
        lo2, hi2 = tr._ring_bounds_halo_z(mesh, sl, per, (2, 1), 0, f_ext=f_ext)
        out[f"bounds/{name}"] = [mesh.all_gather(x, a).numpy() for x, a in ((lo, 1), (hi, 1), (lo2, 0), (hi2, 0))]
        # the differentiable halo: <E x, y> = <x, E^T y> over the whole grid
        # (float64, so that the two sums agree to rounding)
        x = torch.tensor(np.random.default_rng(50).normal(size=(3,) + g.shape))
        xl = shard_rows(mesh, x, 1).requires_grad_()
        y = torch.tensor(np.random.default_rng(51 + mesh.rank).normal(size=(3, xl.shape[1] + 2, g.ny, g.nx)))
        ext = sh.halo_extend_z_diff(mesh, xl, per, 1)
        (gx,) = torch.autograd.grad(ext, xl, y)
        lhs = mesh.all_reduce(torch.sum(ext.detach() * y))
        rhs = mesh.all_reduce(torch.sum(xl.detach() * gx))
        out[f"adjoint/{name}"] = (float(lhs), float(rhs), torch.equal(ext.detach(), sh._halo_extend_z(mesh, xl.detach(), per, 1)))
        # the masked rollout with sources on the shards
        gm, mask, src, state, cfg = _masked_case(per)
        final, diag = euler.rollout_sharded(
            gm, euler.EulerState(shard_rows(mesh, state.sigma), shard_rows(mesh, state.u, 1)), cfg, mesh,
            mask=shard_rows(mesh, mask), source=euler.EulerSource(shard_rows(mesh, src.sigma_rate),
                                                                  shard_rows(mesh, src.force, 1)))
        out[f"masked/{name}"] = (mesh.all_gather(final.sigma, 0).numpy(), mesh.all_gather(final.u, 1).numpy(),
                                 {k: v.numpy() for k, v in diag.items()})
        # the masked rollout in float32 on the smooth obstacle case
        go, mask_o, rate, force, sigma_o, u_o, cfg_o = _obstacle_case(per)
        final, diag = euler.rollout_sharded(
            go, euler.EulerState(shard_rows(mesh, torch.tensor(sigma_o)), shard_rows(mesh, torch.tensor(u_o), 1)),
            cfg_o, mesh, mask=shard_rows(mesh, mask_o),
            source=euler.EulerSource(shard_rows(mesh, torch.tensor(rate)), shard_rows(mesh, torch.tensor(force), 1)))
        out[f"masked32/{name}"] = (mesh.all_gather(final.sigma, 0).numpy(), mesh.all_gather(final.u, 1).numpy(),
                                   {k: v.numpy() for k, v in diag.items()})
        # gradients: the transport rollouts (float32) and the masked rollout (float64)
        for scheme, (seed, steps) in ROLLOUTS.items():
            sigma, u = (torch.tensor(a) for a in _case(g, seed + per))
            tcfg = tr.TransportConfig(dt=0.01, steps=steps, scheme=scheme)
            out[f"grad/{scheme}/{name}"] = _sharded_grad(
                mesh, lambda s, v: (tr.transport_sharded(g, s, v, tcfg, mesh)[0],), (sigma, u),
                (_weights(g.shape, 70),))
        src_l = euler.EulerSource(shard_rows(mesh, src.sigma_rate), shard_rows(mesh, src.force, 1))
        out[f"grad/masked/{name}"] = _sharded_grad(
            mesh, lambda s, v: euler.rollout_sharded(gm, euler.EulerState(s, v), cfg, mesh,
                                                     mask=shard_rows(mesh, mask), source=src_l)[0],
            tuple(state), (_weights(gm.shape, 71, torch.float64), _weights((3,) + gm.shape, 72, torch.float64)))
    # advection: no torch.distributed call may be made
    g, vel, pts0, acfg = _advect_case()
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def refuse(*args, **kw):
        raise AssertionError("advect_sharded made a torch.distributed call")

    try:
        for name in _COLLECTIVES:
            setattr(dist, name, refuse)
        local = adv.advect_sharded(g, vel, pts0, 0.1, acfg, mesh)
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    out["advect"] = mesh.all_gather(local, 0).numpy()
    try:
        adv.advect_sharded(g, vel, pts0[:-1], 0.1, acfg, mesh)
        out["advect uneven"] = False
    except ValueError:
        out["advect uneven"] = True
    return out


_COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single", "all_to_all", "broadcast", "isend", "irecv",
                "send", "recv", "batch_isend_irecv", "reduce_scatter", "barrier")


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def gloo(request):
    """(world size, rank 0's results of _rank_checks on a gloo group)."""
    n = request.param
    return n, run_gloo(_rank_checks, n)[0]


def _jmesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("z",))


def _jgrid(g):
    return jconfig.GridSpec(**dataclasses.asdict(g))


# ---------------------------------------------------------------------------
# tests/test_transport.py:151, :269
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", list(ROLLOUTS))
@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_transport_sharded_matches_single_bitwise(gloo, scheme, boundary):
    """The sharded rollout (halos exchanged, K8's slab form a rank) is the
    single-device transport's result to the bit, its max CFL too; and JAX's
    transport_sharded on a mesh of the same size within the packages'
    rollout class."""
    n, res = gloo
    per = BOUNDARIES[boundary]
    g = _grid(per)
    seed, steps = ROLLOUTS[scheme]
    sigma, u = _case(g, seed + per)
    cfg = tr.TransportConfig(dt=0.01, steps=steps, scheme=scheme)
    single, cfl = tr.transport(g, torch.tensor(sigma), torch.tensor(u), cfg)
    got, cfl_n = res[f"rollout/{scheme}/{boundary}"]
    np.testing.assert_array_equal(got, single.numpy())
    assert cfl_n == float(cfl)
    jout, jcfl = jtr.transport_sharded(_jgrid(g), jnp.asarray(sigma), jnp.asarray(u),
                                       jtr.TransportConfig(dt=0.01, steps=steps, scheme=scheme), _jmesh(n))
    np.testing.assert_allclose(got, np.asarray(jout), rtol=0, atol=JAX_ROLLOUT_ATOL)
    np.testing.assert_allclose(cfl_n, float(jcfl), rtol=1e-6)


@pytest.mark.parametrize("scheme", list(ROLLOUTS))
@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_shard_local_batched_steps_bitwise_per_channel(gloo, scheme, boundary):
    """The batched shard-local step (the self-advection, whose slab is u's
    own, and three other scalars) is the per-channel step to the bit, and
    the single-device batched step's rows."""
    n, res = gloo
    per = BOUNDARIES[boundary]
    g = _grid(per)
    sigma, u = (torch.tensor(a) for a in _case(g, 40 + per))
    cfg = tr.TransportConfig(scheme=scheme)
    single = tr.make_step_many(g, cfg)
    for what, fs in (("self", u), ("three", torch.stack([sigma, u[0], u[1]]))):
        batched, per_channel = res[f"many/{scheme}/{what}/{boundary}"]
        np.testing.assert_array_equal(batched, per_channel)
        np.testing.assert_array_equal(batched, single(fs, u, 0.01).numpy())


@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_ring_bounds_halo_z_bitwise(gloo, boundary):
    """The limiter's bounds from the halo-extended slab are _ring_bounds' to
    the bit, batched (axis 1) and scalar (axis 0)."""
    _, res = gloo
    per = BOUNDARIES[boundary]
    g = _grid(per)
    sigma = torch.tensor(_case(g, 40 + per)[0])
    lo, hi = tr._ring_bounds(sigma, per)
    lo_b, hi_b, lo_s, hi_s = res[f"bounds/{boundary}"]
    for got, want in ((lo_b[0], lo), (hi_b[0], hi), (lo_s, lo), (hi_s, hi)):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_differentiable_halo_is_the_adjoint(gloo, boundary):
    """halo_extend_z_diff's forward is _halo_extend_z's, and its backward
    (each halo plane's cotangent returned to its owner, the clamp's copy to
    the rank's own edge) is the transpose: <E x, y> = <x, E^T y> summed
    over the ranks."""
    _, res = gloo
    lhs, rhs, same = res[f"adjoint/{boundary}"]
    assert same
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("scheme", list(ROLLOUTS))
@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_transport_sharded_gradient_matches_single(gloo, scheme, boundary):
    """The gradient of a loss of transport_sharded's result in sigma0 and u
    (K8's slab step's VJP, the halo planes' cotangents returned to their
    owners) is the single-device transport's within 1e-5 relative L2."""
    _, res = gloo
    g = _grid(BOUNDARIES[boundary])
    seed, steps = ROLLOUTS[scheme]
    sigma, u = (torch.tensor(a) for a in _case(g, seed + BOUNDARIES[boundary]))
    cfg = tr.TransportConfig(dt=0.01, steps=steps, scheme=scheme)
    want = _single_grad(lambda s, v: (tr.transport(g, s, v, cfg)[0],), (sigma, u), (_weights(g.shape, 70),))
    for got, ref in zip(res[f"grad/{scheme}/{boundary}"], want):
        assert rel_l2_err(got, ref) <= 1e-5, rel_l2_err(got, ref)


@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_masked_rollout_sharded_gradient_matches_single(gloo, boundary):
    """The gradient of a loss of the masked rollout on the shards in the
    initial sigma and u (the CGNR solve by implicit differentiation, its
    right-hand side's A^T transposed back, the fluid mean's sum over the
    ranks, the halos' adjoints) is the single-device masked rollout's within
    1e-7 relative L2, in float64 (the module docstring says why not 1e-9)."""
    _, res = gloo
    g, mask, src, state, cfg = _masked_case(BOUNDARIES[boundary])
    want = _single_grad(lambda s, v: euler.rollout(g, euler.EulerState(s, v), cfg, mask=mask, source=src)[0],
                        tuple(state), (_weights(g.shape, 71, torch.float64), _weights((3,) + g.shape, 72, torch.float64)))
    for got, ref in zip(res[f"grad/masked/{boundary}"], want):
        assert rel_l2_err(got, ref) <= 1e-7, rel_l2_err(got, ref)


@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_masked_rollout_sharded_float32_matches_jax(gloo, boundary):
    """The masked rollout on the shards in float32, on the smooth obstacle
    case of tests/test_torch_euler.py, against JAX's rollout(mask=...,
    source=...) with its inputs z-sharded on a mesh of the same size (the
    JAX dry run's phase 10 program): 1e-4 of the field's max on the state,
    max_abs_div within 1e-3 relative, exact zeros in the solid."""
    n, res = gloo
    g, mask, rate, force, sigma, u, cfg = _obstacle_case(BOUNDARIES[boundary])
    got_s, got_u, diag = res[f"masked32/{boundary}"]
    jmesh = _jmesh(n)
    sh_s, sh_u = NamedSharding(jmesh, P("z")), NamedSharding(jmesh, P(None, "z"))
    jg, jcfg = _jgrid(g), jeu.EulerConfig(**dataclasses.asdict(cfg))
    jfinal, jdiag = jax.jit(lambda s, v, m, r, f: jeu.rollout(jg, jeu.EulerState(s, v), jcfg, mask=m,
                                                               source=jeu.EulerSource(r, f)))(
        jax.device_put(jnp.asarray(sigma), sh_s), jax.device_put(jnp.asarray(u), sh_u),
        jax.device_put(jnp.asarray(mask.numpy()), sh_s), jax.device_put(jnp.asarray(rate), sh_s),
        jax.device_put(jnp.asarray(force), sh_u))
    for got, ref in ((got_s, np.asarray(jfinal.sigma)), (got_u, np.asarray(jfinal.u))):
        err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        assert err <= 1e-4, err
    np.testing.assert_allclose(diag["max_abs_div"], np.asarray(jdiag["max_abs_div"]), rtol=1e-3)
    solid = mask.numpy() == 0.0
    assert np.all(got_u[:, solid] == 0.0) and np.all(got_s[solid] == 0.0)


@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_masked_rollout_sharded_matches_single(gloo, boundary):
    """Phase 10 of the dry run on the shards: the Euler rollout with a solid
    box and sources, the masked CGNR projection on the ranks' rows (A^T
    through the differentiable halo, CG's inner products summed in rank
    order), within 1e-9 of the single-device masked rollout in float64;
    exact zeros in the solid."""
    _, res = gloo
    g, mask, src, state, cfg = _masked_case(BOUNDARIES[boundary])
    f1, d1 = euler.rollout(g, state, cfg, mask=mask, source=src)
    sigma, u, diag = res[f"masked/{boundary}"]
    assert sigma.dtype == np.float64
    assert rel_l2_err(sigma, f1.sigma.numpy()) <= 1e-9
    assert rel_l2_err(u, f1.u.numpy()) <= 1e-9
    np.testing.assert_allclose(diag["kinetic_energy"], d1["kinetic_energy"].numpy(), rtol=1e-9)
    solid = mask.numpy() == 0.0
    assert np.all(u[:, solid] == 0.0) and np.all(sigma[solid] == 0.0)
    assert np.all(np.isfinite(diag["max_abs_div"]))


# ---------------------------------------------------------------------------
# tests/test_sample_advect.py:272
# ---------------------------------------------------------------------------


def test_advect_sharded_matches_single_and_has_no_collectives(gloo):
    """Each rank advects its block through the same advect(): the blocks,
    gathered, are advect()'s result to the bit, with every torch.distributed
    call patched to raise; a particle count that does not divide over the
    ranks raises ValueError."""
    _, res = gloo
    g, vel, pts0, acfg = _advect_case()
    np.testing.assert_array_equal(res["advect"], adv.advect(g, vel, pts0, 0.1, acfg).numpy())
    assert res["advect uneven"]


# ---------------------------------------------------------------------------
# K8's slab form, serial shards in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(8, 6, 16), (13, 7, 12), (9, 5, 4), (33, 3, 3)], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("boundary", list(BOUNDARIES))
def test_slab_plain_twin_on_serial_shards_bitwise(dims, boundary):
    """transport_step_slab's plain twin on every shard of the 1- to 4-way
    splits (ragged ny and nx, nz_local = 1 included), its halo planes the
    neighbouring rows, is the whole-grid plain step's rows to the bit, for
    C = 1, three scalars and u itself, +dt and -dt; the wrapper takes the
    plain twin on the CPU."""
    g = GridSpec(*dims, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=BOUNDARIES[boundary])
    sigma, u = _case(g, 60)
    sigma, u = torch.tensor(sigma), torch.tensor(u) * 0.01 / 0.5
    for fields in (sigma[None], torch.stack([sigma, u[0], u[2]]), u):
        for dt in (0.5, -0.5):
            whole = ktr.transport_step_many_plain(g, fields, u, dt)
            for n in (1, 2, 3, 4):
                if g.nz % n:
                    continue
                nzl = g.nz // n
                for r in range(n):
                    rows = z_rows(g, r * nzl - 1, (r + 1) * nzl + 1)
                    u_ext = u[:, rows]
                    f_ext = u_ext if fields is u else fields[:, rows]
                    plain = ktr.transport_step_slab_plain(g, f_ext, u_ext, dt)
                    torch.testing.assert_close(plain, whole[:, r * nzl:(r + 1) * nzl], rtol=0, atol=0)
                    assert torch.equal(ktr.transport_step_slab(g, f_ext, u_ext, dt), plain)


def test_slab_step_autograd_is_the_plain_vjp():
    """transport_step_slab's backward (the plain slab step's VJP) against
    autograd of the plain slab step."""
    g = GridSpec(13, 7, 4, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=False)
    sigma, u = _case(dataclasses.replace(g, nz=6), 61)
    f = torch.tensor(sigma)[None].requires_grad_()
    v = (torch.tensor(u) * 0.01 / 0.5).requires_grad_()
    ct = torch.tensor(np.random.default_rng(62).normal(size=(1, 4, 7, 13)).astype(np.float32))
    got = torch.autograd.grad(ktr.transport_step_slab(g, f, v, 0.5), (f, v), ct)
    want = torch.autograd.grad(ktr.transport_step_slab_plain(g, f, v, 0.5), (f, v), ct)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_slab_step_checks_its_shapes():
    g = GridSpec(8, 6, 16, hx=0.5, hy=0.25, hz=0.4, dt=1e-3)
    with pytest.raises(ValueError, match="nz_local"):
        ktr.transport_step_slab(g, torch.zeros(1, 2, 6, 8), torch.zeros(3, 2, 6, 8), 0.1)
    with pytest.raises(ValueError, match="u_ext"):
        ktr.transport_step_slab(g, torch.zeros(1, 5, 6, 8), torch.zeros(3, 4, 6, 8), 0.1)
