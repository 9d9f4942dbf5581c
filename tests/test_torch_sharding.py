"""The z-sharded paths of the port (phys_autodiff_tpu_torch/parallel/) on
gloo groups of 2 and 4 CPU processes, vs the JAX package's sharded
functions on a mesh of the same size (tests/conftest.py's CPU devices;
Pallas in interpret mode) and vs the port's own single-device results.

Ports tests/test_sharding.py (tests/test_torch_sharded_convergence.py
ports tests/test_sharded_convergence.py), holds the 2-D (z, h) step on
z1 x h2 (2 ranks) and z2 x h2 (4 ranks) against JAX's
make_sharded_train_step_2d on a mesh of the same shape and the port's
single-device staged step, and runs entry.dryrun_multichip. One
gloo spawn a world size (the module fixture `gloo`) runs every check on
every rank and returns rank 0's results (fields gathered in z order); each
test reads its entry. Tolerances are the JAX tests': residuals 1e-7
relative L2 and 1e-6 max; the fixed-order fused losses 1e-7 relative; the
unconstrained loss sum 1e-4; training steps 1e-6 (staged) or 5e-6 (fused)
on the loss and 1e-6 relative L2 on every parameter after the step. The
port against JAX is held to the same classes, but the
fixed-order losses, which are held to each other's at 1e-6 (K1's class in
tests/test_torch_residuals.py), and the training steps' losses, at 1e-5
(tests/test_torch_train.py's class): two packages' float32 sums and fields
differ in their last bits. The generic steps' first loss is held to the
single device's at 1e-5 and, for the solenoidal head, to JAX's at 1e-5
(tests/test_sharding.py:393); the NGP field's first loss to JAX's at 1e-4:
from its seed-2 init the loss is 0.098, a near cancellation that JAX's own
eager and jitted evaluations of it put about 1.1e-4 apart
(test_generic_ngp_first_loss_spread_in_jax measures it). The 2-D
step's loss to both at 1e-5 (its layer 2 adds the h ranks' partial
products: another order than the single device's) and every parameter at
1e-6 relative L2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax.sharding import Mesh

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.models import solenoidal as jsolenoidal
from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig as JHashEncodingConfig
from phys_autodiff_tpu.ops.loss import loss_forward_planewise as jplanewise
from phys_autodiff_tpu.ops.loss import total_loss as jtotal_loss
from phys_autodiff_tpu.ops.stencil import FieldSnapshots as JFields
from phys_autodiff_tpu.pallas.mega_bwd import mega_loss_and_grad as jmega_lg
from phys_autodiff_tpu.parallel import (
    loss_forward_fused_sharded as jloss_fused_sharded,
    make_generic_sharded_train_step as jgeneric_step,
    make_mesh as jmake_mesh,
    make_sharded_fused_train_step as jfused_step,
    make_sharded_train_step as jtrain_step,
    make_sharded_train_step_2d as jtrain_step_2d,
    residuals_fused_sharded as jres_fused_sharded,
    residuals_sharded as jres_sharded,
    shard_fields as jshard_fields,
)
from phys_autodiff_tpu.ref import manufactured
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import mega_bwd as kb
from phys_autodiff_tpu_torch.kernels.residuals import loss_forward_fused, residuals_fused
from phys_autodiff_tpu_torch.models import ngp, solenoidal
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.ops.diagnostics import divergence
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.parallel import make_mesh_2d, shard_fields
from phys_autodiff_tpu_torch.parallel import sharded as sh
from phys_autodiff_tpu_torch.parallel.launch import run_gloo
from phys_autodiff_tpu_torch.train import TrainConfig, loop, state_from_params
from phys_autodiff_tpu_torch.train.slab_grad import make_slab_loss_and_grad
from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

torch.set_num_threads(1)

L = 2 * np.pi
SIZES = (2, 4)
W = PhysWeights(w_sigma=1.7, w_u=0.9)
W_UP = PhysWeights(w_sigma=1.1, w_u=0.6)
MCFG = MLPGridConfig(dims=MLPDims(H=32))
G_MEGA = GridSpec(nx=128, ny=8, nz=16, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)
AUTO = {"upwind-aligned": ("upwind", 128, 8), "central-flat": ("central", 64, 16), "upwind-flat": ("upwind", 64, 16)}
FIELD_GRIDS = ("periodic", "clamp", "upwind")
#: The port's loss against the JAX package's: two float32 sums of the same
#: planes in other orders, the class tests/test_torch_residuals.py holds K1's
#: loss to (1e-6); the 1e-7 doctrine holds each package's sharded loss
#: against its own single-device loss.
JAX_LOSS_REL = 1e-6
#: A training step's loss against the JAX package's: the MLP's fields differ
#: in their last bits between the packages, and 1/(2 dt) magnifies that in
#: the residual; tests/test_torch_train.py's class (1e-5).
JAX_STEP_LOSS_REL = 1e-5


def _grid(variant="periodic", nx=32):
    return GridSpec(nx=nx, ny=16, nz=16, hx=L / nx, hy=L / 16, hz=L / 16, dt=1e-3, periodic=variant != "clamp",
                    scheme="upwind" if variant == "upwind" else "central")


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (CoordNorm converted too: the JAX MLP tests the enum by identity)."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    return getattr(jconfig, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _fields_np(g):
    f = manufactured.solution2_fields(_jax(g), 0.7)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in f.items()}


def _torch_fields(f):
    return FieldSnapshots(**{k: torch.tensor(v) for k, v in f.items()})


def _params(seed):
    return {k: np.asarray(v) for k, v in jmlp.init_params(jconfig.MLPDims(H=32), seed=seed).items()}


def _np(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# The checks every gloo rank runs (results: rank 0's, fields gathered)
# ---------------------------------------------------------------------------


def _rank_checks(mesh, fields, p5):
    out = {}
    for variant in FIELD_GRIDS:
        g = _grid(variant)
        fl = shard_fields(mesh, _torch_fields(fields[variant]))
        rs, ru = sh.residuals_sharded(g, mesh, fl)
        out[f"gspmd_res/{variant}"] = [mesh.all_gather(rs, 0).numpy(), mesh.all_gather(ru, 1).numpy()]
        rs, ru = sh.residuals_fused_sharded(g, mesh, fl)
        out[f"fused_res/{variant}"] = [mesh.all_gather(rs, 0).numpy(), mesh.all_gather(ru, 1).numpy()]
        w = W_UP if variant == "upwind" else W
        out[f"fused_loss/{variant}"] = [float(x) for x in sh.loss_forward_fused_sharded(g, w, mesh, fl)]
        if variant == "periodic":
            rs, ru = sh.residuals_sharded(g, mesh, fl)
            inv_n = float(ops_loss.inv_n_f32(g))
            out["staged_loss"] = [float(mesh.all_reduce(torch.sum(rs * rs))) * float(np.float32(W.w_sigma)) * inv_n,
                                  float(mesh.all_reduce(torch.sum(ru * ru))) * float(np.float32(W.w_u)) * inv_n]
            parts = mesh.all_gather(ops_loss.plane_partials(rs, ru), 1)
            out["planewise"] = [float(x) for x in ops_loss.sum_partials(g, W, parts)]
    g = _grid()
    pw = PhysWeights()
    step, init = sh.make_sharded_fused_train_step(g, pw, MCFG, mesh, 1e-3, sz=2)
    state, l1 = step(init({k: torch.tensor(v) for k, v in p5.items()}), 0.25)
    p_after = _np(state.params)
    _, l2 = step(state, 0.25)
    out["fused_step"] = [float(l1), p_after, float(l2)]
    step, init = sh.make_sharded_train_step(g, pw, MCFG, mesh, 1e-3)
    state, loss = step(init({k: torch.tensor(v) for k, v in p5.items()}), 0.25)
    out["train_step"] = [float(loss), _np(state.params)]
    step, init = sh.make_sharded_fused_train_step(G_MEGA, pw, MCFG, mesh, 1e-3, backward="mega")
    state, loss = step(init({k: torch.tensor(v) for k, v in p5.items()}), 0.25)
    out["mega_step"] = [float(loss), _np(state.params)]
    for name, (scheme, nx, ny) in AUTO.items():
        ga = dataclasses.replace(G_MEGA, nx=nx, ny=ny, scheme=scheme)
        step, init = sh.make_sharded_fused_train_step(ga, pw, MCFG, mesh, 1e-3, backward="auto")
        state, loss = step(init({k: torch.tensor(v) for k, v in p5.items()}), 0.25)
        out[f"auto/{name}"] = [float(loss), _np(state.params)]
    # the generic step: the NGP hash field (8 steps), the solenoidal head (10)
    for name, (gen, p0, steps) in _generic_cases(g).items():
        step, init = sh.make_generic_sharded_train_step(g, pw, gen, mesh, p0, learning_rate=3e-3)
        state, losses = init(), []
        for _ in range(steps):
            state, loss = step(state, 0.3)
            losses.append(float(loss))
        out[f"generic/{name}"] = [losses, {k: v.detach().numpy() for k, v in state.params.items()
                                           if isinstance(v, torch.Tensor)}]
    # the 2-D step, z n/2 x h 2
    mesh2 = make_mesh_2d(2, device="cpu")
    step, init = sh.make_sharded_train_step_2d(g, pw, MCFG, mesh2, 1e-3)
    state, loss = step(init({k: torch.tensor(v) for k, v in p5.items()}), 0.25)
    # a halo exchange over the z subgroup reaches the z neighbours' world ranks
    ext = sh._halo_extend_z(mesh2.z, torch.full((1, 2, 2), float(mesh.rank)), True)
    out["train_step_2d"] = [float(loss), _np(sh.gather_params_2d(mesh2, state.params)), mesh2.shape,
                            [float(ext[0, 0, 0]), float(ext[-1, 0, 0])]]
    return out


NGP_GENERIC = HashEncodingConfig(num_levels=3, features_per_level=2, log2_table_size=10, base_resolution=4,
                                 max_resolution=16)
SOLENOIDAL = MLPGridConfig(dims=MLPDims(H=16))


def _generic_cases(g):
    """tests/test_sharding.py:311 and :346's generators: name -> (generate_fn,
    params0, steps)."""
    ncfg = ngp.NGPFieldConfig(encoding=NGP_GENERIC, hidden=16)
    return {
        "ngp": (lambda p, t: ngp.generate_fields(g, ncfg, p, t, g.dt), ngp.init_ngp_params(ncfg, seed=2, device="cpu"),
                8),
        "solenoidal": (lambda p, t: solenoidal.generate_fields_solenoidal(g, SOLENOIDAL, p, t, g.dt),
                       tmlp.init_params(SOLENOIDAL.dims, seed=3, device="cpu"), 10),
    }


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def gloo(request):
    """(world size, rank 0's results of _rank_checks on a gloo group)."""
    fields = {v: _fields_np(_grid(v)) for v in FIELD_GRIDS}
    n = request.param
    return n, run_gloo(_rank_checks, n, fields, _params(5))[0]


def _jfields(g):
    return JFields(**{k: jnp.asarray(v) for k, v in _fields_np(g).items()})


def _close_residuals(got, ref):
    assert rel_l2_err(got[0], ref[0]) <= 1e-7
    assert max_abs_err(got[0], ref[0]) <= 1e-6
    assert rel_l2_err(got[1], ref[1]) <= 1e-7


# ---------------------------------------------------------------------------
# tests/test_sharding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_gspmd_residuals_match_single_device(gloo, periodic):
    n, res = gloo
    variant = "periodic" if periodic else "clamp"
    g = _grid(variant)
    single = [x.numpy() for x in ops_stencil.residuals(g, _torch_fields(_fields_np(g)))]
    _close_residuals(res[f"gspmd_res/{variant}"], single)
    jx = jax.jit(lambda x: jres_sharded(_jax(g), jmake_mesh(n), x))(jshard_fields(jmake_mesh(n), _jfields(g)))
    _close_residuals(res[f"gspmd_res/{variant}"], [np.asarray(a) for a in jx])


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_shard_map_fused_residuals_match_single_device(gloo, periodic):
    n, res = gloo
    variant = "periodic" if periodic else "clamp"
    g = _grid(variant)
    single = [x.numpy() for x in residuals_fused(g, _torch_fields(_fields_np(g)))]
    _close_residuals(res[f"fused_res/{variant}"], single)
    mesh = jmake_mesh(n)
    jx = jax.jit(lambda x: jres_fused_sharded(_jax(g), mesh, x, interpret=True))(jshard_fields(mesh, _jfields(g)))
    _close_residuals(res[f"fused_res/{variant}"], [np.asarray(a) for a in jx])


def test_sharded_loss_matches_single_device(gloo):
    """The unconstrained sum (local sums all-reduced) against the
    single-device loss: 1e-4, as the JAX test holds the psum arm."""
    n, res = gloo
    g = _grid()
    ls_1, lu_1 = ops_loss.loss_forward(g, W, _torch_fields(_fields_np(g)))
    ls_n, lu_n = res["staged_loss"]
    assert abs(ls_n - float(ls_1)) / abs(float(ls_1)) <= 1e-4
    assert abs(lu_n - float(lu_1)) / abs(float(lu_1)) <= 1e-4
    jls, jlu = jax.jit(lambda x: jops.loss_terms(_jax(g), _jax(W), *jres_sharded(_jax(g), jmake_mesh(n), x)))(
        jshard_fields(jmake_mesh(n), _jfields(g)))
    assert abs(ls_n - float(jls)) / abs(float(jls)) <= 1e-4
    assert abs(lu_n - float(jlu)) / abs(float(jlu)) <= 1e-4


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_sharded_fused_loss_deterministic_1e7(gloo, periodic):
    """The fused sharded loss (halo exchange, K1's plane partials per rank,
    the fixed-order chain) meets the single-device fused loss at 1e-7, and
    JAX's loss_forward_fused_sharded on a mesh of the same size."""
    n, res = gloo
    variant = "periodic" if periodic else "clamp"
    g = _grid(variant)
    ls_1, lu_1 = loss_forward_fused(g, W, _torch_fields(_fields_np(g)))
    ls_n, lu_n = res[f"fused_loss/{variant}"]
    assert abs(ls_n - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(lu_n - float(lu_1)) / abs(float(lu_1)) <= 1e-7
    mesh = jmake_mesh(n)
    jls, jlu = jax.jit(lambda x: jloss_fused_sharded(_jax(g), _jax(W), mesh, x, interpret=True))(
        jshard_fields(mesh, _jfields(g)))
    assert abs(ls_n - float(jls)) / abs(float(jls)) <= JAX_LOSS_REL
    assert abs(lu_n - float(jlu)) / abs(float(jlu)) <= JAX_LOSS_REL


def test_sharded_planewise_staged_loss_1e7(gloo):
    n, res = gloo
    g = _grid()
    ls_1, lu_1 = ops_loss.loss_forward_planewise(g, W, _torch_fields(_fields_np(g)))
    ls_n, lu_n = res["planewise"]
    assert abs(ls_n - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(lu_n - float(lu_1)) / abs(float(lu_1)) <= 1e-7
    jls, jlu = jax.jit(lambda x: jplanewise(_jax(g), _jax(W), x))(_jfields(g))
    assert abs(ls_n - float(jls)) / abs(float(jls)) <= JAX_LOSS_REL
    assert abs(lu_n - float(jlu)) / abs(float(jlu)) <= JAX_LOSS_REL


def _adam_step(params, grads, lr=1e-3):
    """One optax.adam update of JAX-side params."""
    opt = optax.adam(lr)
    up, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, up)


def _port_step(params_np, loss_and_grad, lr=1e-3):
    """One port adam update (train/loop.py) from loss_and_grad(params)."""
    cfg = TrainConfig(learning_rate=lr)
    state = state_from_params(cfg, {k: torch.tensor(v) for k, v in params_np.items()})
    loss, grads = loss_and_grad(state.params)
    state = loop._apply_grads(cfg, loop.make_schedule(cfg), state, grads)
    return float(loss), _np(state.params)


def _close_step(got, ref_loss, ref_params, loss_tol):
    loss, params = got[0], got[1]
    assert abs(loss - ref_loss) / abs(ref_loss) <= loss_tol, (loss, ref_loss)
    for k in ref_params:
        assert rel_l2_err(params[k], np.asarray(ref_params[k])) <= 1e-6, k


def test_sharded_fused_train_step_matches_single(gloo):
    """The sharded fused step's slab arm (sz = 2) against the single-device
    slab-gradient step and JAX's sharded fused step; a second step stays
    finite and lowers the loss."""
    n, res = gloo
    g = _grid()
    p = _params(5)
    lg = make_slab_loss_and_grad(g, PhysWeights(), MCFG, sz=2)
    l1, p1 = _port_step(p, lambda q: (lambda r: (r[0], r[1][0]))(lg(q, 0.25)))
    _close_step(res["fused_step"], l1, p1, 5e-6)
    step_j, init_j = jfused_step(_jax(g), jconfig.PhysWeights(), _jax(MCFG), jmake_mesh(n), 1e-3, sz=2)
    pj, oj = init_j({k: jnp.asarray(v) for k, v in p.items()})
    pj, oj, lj = step_j(pj, oj, jnp.float32(0.25))
    _close_step(res["fused_step"], float(lj), pj, JAX_STEP_LOSS_REL)
    l2 = res["fused_step"][2]
    assert np.isfinite(l2) and l2 < res["fused_step"][0]


def test_sharded_train_step_matches_single_device(gloo):
    """One staged sharded step (replicated params, each rank's rows and
    halo rows, all-reduced gradients) against the single-device step and
    JAX's sharded step."""
    n, res = gloo
    g = _grid()
    cfg = TrainConfig(steps=1, learning_rate=1e-3, t=0.25, seed=5)
    state = loop.init_state(cfg, MCFG, device="cpu")
    state, loss1 = loop.make_train_step(g, PhysWeights(), MCFG, cfg)(state)
    _close_step(res["train_step"], float(loss1), _np(state.params), 1e-6)
    step_j, init_j = jtrain_step(_jax(g), jconfig.PhysWeights(), _jax(MCFG), jmake_mesh(n), 1e-3)
    pj, oj = init_j({k: jnp.asarray(v) for k, v in _params(5).items()})
    pj, oj, lj = step_j(pj, oj, jnp.float32(0.25))
    _close_step(res["train_step"], float(lj), pj, JAX_STEP_LOSS_REL)


@functools.lru_cache(maxsize=None)
def _mega_single(g):
    """The single-device K4 step (its plain version) from seed 5's params;
    one run serves both world sizes."""
    return _port_step(_params(5), lambda q: (lambda r: (r[0], r[1][0]))(
        kb.mega_loss_and_grad(g, PhysWeights(), MCFG, q, 0.25)))


def test_sharded_mega_bwd_step_matches_single(gloo):
    """backward="mega": K4's shard-local build (its plain version here) a
    rank; the step matches the single-device K4 step and JAX's sharded mega
    step on a mesh of the same size."""
    n, res = gloo
    p = _params(5)
    _close_step(res["mega_step"], *_mega_single(G_MEGA), 5e-6)
    step_j, init_j = jfused_step(_jax(G_MEGA), jconfig.PhysWeights(), _jax(MCFG), jmake_mesh(n), 1e-3,
                                 backward="mega")
    pj, oj = init_j({k: jnp.asarray(v) for k, v in p.items()})
    pj, oj, lj = step_j(pj, oj, jnp.float32(0.25))
    _close_step(res["mega_step"], float(lj), pj, JAX_STEP_LOSS_REL)


@pytest.mark.parametrize("name", list(AUTO))
def test_sharded_mega_bwd_auto_routing_matches_single(gloo, name):
    """backward="auto" takes K4's shard-local build for upwind and unaligned
    planes (within K4's gate); each class against the single-device K4 step
    and JAX's single-chip mega step (the JAX test's reference)."""
    n, res = gloo
    scheme, nx, ny = AUTO[name]
    g = dataclasses.replace(G_MEGA, nx=nx, ny=ny, scheme=scheme)
    assert kb.mega_supported(g) and kb.mega_fits(g, MCFG.dims.H)
    p = _params(5)
    _close_step(res[f"auto/{name}"], *_mega_single(g), 5e-6)
    l1, (gp1, _) = jax.jit(lambda q: jmega_lg(_jax(g), jconfig.PhysWeights(), _jax(MCFG), q, jnp.float32(0.25),
                                              "f32", True))({k: jnp.asarray(v) for k, v in p.items()})
    _close_step(res[f"auto/{name}"], float(l1), _adam_step({k: jnp.asarray(v) for k, v in p.items()}, gp1),
                JAX_STEP_LOSS_REL)


def test_shard_map_fused_residuals_upwind_scheme(gloo):
    """The halo-extended slab's grid keeps the upwind scheme."""
    n, res = gloo
    g = _grid("upwind")
    single = [x.numpy() for x in ops_stencil.residuals(g, _torch_fields(_fields_np(g)))]
    _close_residuals(res["fused_res/upwind"], single)
    mesh = jmake_mesh(n)
    jx = jax.jit(lambda x: jres_fused_sharded(_jax(g), mesh, x, interpret=True))(jshard_fields(mesh, _jfields(g)))
    _close_residuals(res["fused_res/upwind"], [np.asarray(a) for a in jx])


def test_sharded_fused_loss_upwind_1e7(gloo):
    n, res = gloo
    g = _grid("upwind")
    ls_1, lu_1 = loss_forward_fused(g, W_UP, _torch_fields(_fields_np(g)))
    ls_n, lu_n = res["fused_loss/upwind"]
    assert abs(ls_n - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(lu_n - float(lu_1)) / abs(float(lu_1)) <= 1e-7
    mesh = jmake_mesh(n)
    jls, jlu = jax.jit(lambda x: jloss_fused_sharded(_jax(g), _jax(W_UP), mesh, x, interpret=True))(
        jshard_fields(mesh, _jfields(g)))
    assert abs(ls_n - float(jls)) / abs(float(jls)) <= JAX_LOSS_REL
    assert abs(lu_n - float(jlu)) / abs(float(jlu)) <= JAX_LOSS_REL


def _jax_generic_first_loss(n, name):
    """JAX's make_generic_sharded_train_step on an n-device mesh: the first
    step's loss (the loss of params0)."""
    g = _jax(_grid())
    if name == "ngp":
        ncfg = jngp.NGPFieldConfig(encoding=JHashEncodingConfig(**dataclasses.asdict(NGP_GENERIC)), hidden=16)
        p0 = jngp.init_ngp_params(ncfg, seed=2)
        gen = lambda p, t: jngp.generate_fields(g, ncfg, p, t, g.dt)  # noqa: E731
    else:
        p0 = jmlp.init_params(jconfig.MLPDims(H=16), seed=3)
        gen = lambda p, t: jsolenoidal.generate_fields_solenoidal(g, _jax(SOLENOIDAL), p, t, g.dt)  # noqa: E731
    step, init = jgeneric_step(g, jconfig.PhysWeights(), gen, jmake_mesh(n), p0, learning_rate=3e-3)
    params, opt = init()
    _, _, loss = step(params, opt, jnp.float32(0.3))
    return float(loss)


def test_generic_ngp_first_loss_spread_in_jax():
    """Why the NGP field's first loss is held to JAX's at 1e-4, not 1e-5:
    JAX's own eager and jitted single-device evaluations of that loss
    (params0, t = 0.3) lie more than 5e-5 apart (about 1.1e-4 on the CPU),
    and the port's single-device loss lies within 1e-4 of the jitted one
    (the form the JAX step runs; about 7e-5)."""
    g = _jax(_grid())
    ncfg = jngp.NGPFieldConfig(encoding=JHashEncodingConfig(**dataclasses.asdict(NGP_GENERIC)), hidden=16)
    p0 = jngp.init_ngp_params(ncfg, seed=2)

    def loss(p):
        return jtotal_loss(g, jconfig.PhysWeights(), jngp.generate_fields(g, ncfg, p, jnp.float32(0.3), g.dt))

    eager, jitted = float(loss(p0)), float(jax.jit(loss)(p0))
    assert abs(eager - jitted) / jitted >= 5e-5, (eager, jitted)
    gen, params0, _ = _generic_cases(_grid())["ngp"]
    port = float(ops_loss.total_loss(_grid(), PhysWeights(), gen(params0, 0.3)))
    assert abs(port - jitted) / jitted <= 1e-4, (port, jitted)


@pytest.mark.parametrize("name", ["ngp", "solenoidal"])
def test_generic_sharded_train_step(gloo, name):
    """tests/test_sharding.py:311 (the NGP hash field, 8 steps) and :346 (the
    solenoidal head, 10 steps) through the generic sharded step: finite and
    decreasing losses, the first step's loss the single device's at 1e-5
    and JAX's on a mesh of the same size (1e-5; the NGP field's 1e-4, see
    the module docstring); the solenoidal field stays
    divergence-free (1e-5 of its largest speed)."""
    n, res = gloo
    g = _grid()
    losses, params = res[f"generic/{name}"]
    gen, p0, _ = _generic_cases(g)[name]
    single = float(ops_loss.total_loss(g, PhysWeights(), gen(p0, 0.3)))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert abs(losses[0] - single) / single <= 1e-5, (losses[0], single)
    jloss = _jax_generic_first_loss(n, name)
    assert abs(losses[0] - jloss) / jloss <= (1e-4 if name == "ngp" else 1e-5), (losses[0], jloss)
    if name == "solenoidal":
        _, u = solenoidal.grid_infer_solenoidal(g, SOLENOIDAL, {k: torch.tensor(v) for k, v in params.items()}, 0.3)
        umax = float(torch.max(torch.abs(u))) + 1e-30
        assert float(torch.max(torch.abs(divergence(g, u)))) <= 1e-5 * umax


def test_sharded_train_step_2d_matches_jax_and_single(gloo):
    """One step on the (z, h) mesh (z1 x h2 at 2 ranks, z2 x h2 at 4): W1 and
    b1 column-sharded, W2 row-sharded, layer 2's partial products summed
    over h with an identity backward, gradients and loss reduced over z;
    against JAX's make_sharded_train_step_2d on a mesh of the same shape and
    the port's single-device staged step."""
    n, res = gloo
    loss, params, shape, halo = res["train_step_2d"]
    assert shape == {"z": n // 2, "h": 2}
    # rank 0's z neighbours: itself on z1 x h2, world rank 2 on z2 x h2
    assert halo == ([0.0, 0.0] if n == 2 else [2.0, 2.0])
    g = _grid()
    cfg = TrainConfig(steps=1, learning_rate=1e-3, t=0.25, seed=5)
    state = loop.init_state(cfg, MCFG, device="cpu")
    state, loss1 = loop.make_train_step(g, PhysWeights(), MCFG, cfg)(state)
    _close_step([loss, params], float(loss1), _np(state.params), JAX_STEP_LOSS_REL)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n // 2, 2), ("z", "h"))
    step_j, init_j = jtrain_step_2d(_jax(g), jconfig.PhysWeights(), _jax(MCFG), mesh, 1e-3)
    pj, oj = init_j({k: jnp.asarray(v) for k, v in _params(5).items()})
    pj, oj, lj = step_j(pj, oj, jnp.float32(0.25))
    _close_step([loss, params], float(lj), {k: np.asarray(v) for k, v in pj.items()}, JAX_STEP_LOSS_REL)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_multichip_runs_to_its_ok_lines(n):
    """Every "ok" line of the JAX dry run, in its order: phase 1 on the 2-D
    (z, h) mesh where n is even and above 2 (z n/2 x h 2), else on the z
    mesh; every other phase on the z mesh."""
    from phys_autodiff_tpu_torch.entry import dryrun_multichip

    lines = dryrun_multichip(n)
    names = ["ok", "fused ok", "mega ok", "ngp ok", "fourier ok", "advect ok", "transport ok", "euler ok", "fit ok",
             "fit-mega ok", "euler-obstacle-source ok", "fit-ngp-fast-bf16 ok", "ngp-fast-bf16 ok", "convergence ok"]
    assert [line.split(":")[0] for line in lines] == [f"dryrun_multichip {x}" for x in names]
    first = f"mesh={{'z': {n // 2}, 'h': 2}}" if n % 2 == 0 and n > 2 else f"mesh={{'z': {n}}}"
    assert first in lines[0]
    assert all(f"mesh={{'z': {n}}}" in line for line in lines[1:])
