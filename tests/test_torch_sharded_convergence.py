"""Multi-step sharded convergence of the port (phys_autodiff_tpu_torch/
parallel/sharded.py) on gloo groups of 2 and 4 CPU processes: ports
tests/test_sharded_convergence.py. The reference's M6 criterion (training
drops the physics loss by 90% within the budgeted steps) on the mesh, for
the staged step (300 steps) and the fused step's slab arm (150 steps,
sz = 1), the latter on the single-device fused step's trajectory with the
same slabs (1e-5 a step, as the JAX test holds its own); the first steps
against the JAX package's sharded steps on a mesh of the same size (1e-5,
tests/test_torch_train.py's class for a step's loss across the packages).
One gloo spawn a world size (the module fixture `gloo`) runs both
trajectories on every rank and returns rank 0's losses.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.parallel import (
    make_mesh as jmake_mesh,
    make_sharded_fused_train_step as jfused_step,
    make_sharded_train_step as jtrain_step,
)
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.parallel import sharded as sh
from phys_autodiff_tpu_torch.parallel.launch import run_gloo
from phys_autodiff_tpu_torch.train import TrainConfig, loop, state_from_params
from phys_autodiff_tpu_torch.train.slab_grad import make_fused_loss

torch.set_num_threads(1)

SIZES = (2, 4)
MCFG = MLPGridConfig(dims=MLPDims(H=32))
G_CONV = GridSpec(nx=16, ny=16, nz=16, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
CONV_FUSED_STEPS = 150
#: A training step's loss against the JAX package's (tests/test_torch_train.py).
JAX_STEP_LOSS_REL = 1e-5


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    return getattr(jconfig, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _params(seed):
    return {k: np.asarray(v) for k, v in jmlp.init_params(jconfig.MLPDims(H=32), seed=seed).items()}


def _rank_checks(mesh, p1):
    out = {}
    pw = PhysWeights()
    step, init = sh.make_sharded_train_step(G_CONV, pw, MCFG, mesh, learning_rate=3e-3)
    state = init({k: torch.tensor(v) for k, v in p1.items()})
    losses = []
    for _ in range(300):
        state, loss = step(state, 0.25)
        losses.append(float(loss))
    out["conv_gspmd"] = losses
    step, init = sh.make_sharded_fused_train_step(G_CONV, pw, MCFG, mesh, learning_rate=3e-3, sz=1)
    state = init({k: torch.tensor(v) for k, v in p1.items()})
    losses = []
    for _ in range(CONV_FUSED_STEPS):
        state, loss = step(state, 0.25)
        losses.append(float(loss))
    out["conv_fused"] = losses
    return out


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def gloo(request):
    """(world size, rank 0's losses of _rank_checks on a gloo group)."""
    n = request.param
    return n, run_gloo(_rank_checks, n, _params(1))[0]


def test_gspmd_sharded_training_drops_90_percent(gloo):
    """300 staged sharded steps drop the loss by 90%; the first steps are
    JAX's sharded step's on a mesh of the same size (1e-5)."""
    n, res = gloo
    losses = res["conv_gspmd"]
    assert np.isfinite(losses[-1])
    assert losses[-1] <= 0.1 * losses[0], (losses[0], losses[-1])
    step_j, init_j = jtrain_step(_jax(G_CONV), jconfig.PhysWeights(), _jax(MCFG), jmake_mesh(n), learning_rate=3e-3)
    pj, oj = init_j({k: jnp.asarray(v) for k, v in _params(1).items()})
    for i in range(3):
        pj, oj, lj = step_j(pj, oj, jnp.float32(0.25))
        assert abs(losses[i] - float(lj)) <= JAX_STEP_LOSS_REL * abs(float(lj)), (i, losses[i], float(lj))


@functools.lru_cache(maxsize=None)
def _single_fused_trajectory():
    """The single-device fused step's losses over CONV_FUSED_STEPS steps with
    the same slabs (make_fused_loss(sz=1, backward="slab"))."""
    cfg = TrainConfig(learning_rate=3e-3)
    state = state_from_params(cfg, {k: torch.tensor(v) for k, v in _params(1).items()})
    loss_fn = make_fused_loss(G_CONV, PhysWeights(), MCFG, sz=1, backward="slab")
    schedule = loop.make_schedule(cfg)
    losses = []
    for _ in range(CONV_FUSED_STEPS):
        with torch.enable_grad():
            l1 = loss_fn(state.params, 0.25)
            grads = dict(zip(state.params, torch.autograd.grad(l1, list(state.params.values()))))
        losses.append(float(l1.detach()))
        state = loop._apply_grads(cfg, schedule, state, grads)
    return losses


def test_shardmap_fused_training_drops_90_percent_and_matches_single(gloo):
    """The sharded fused step (slab arm, sz = 1) drops the loss by 90% in
    150 steps and stays on the single-device fused step's trajectory with
    the same slabs (make_fused_loss(sz=1, backward="slab"); 1e-5 a step,
    as the JAX test holds its own); its first step is JAX's sharded fused
    step's."""
    n, res = gloo
    losses = res["conv_fused"]
    for i, l1 in enumerate(_single_fused_trajectory()):
        assert abs(losses[i] - l1) <= 1e-5 * max(abs(l1), 1e-6), (i, losses[i], l1)
    assert losses[-1] <= 0.1 * losses[0]
    step_j, init_j = jfused_step(_jax(G_CONV), jconfig.PhysWeights(), _jax(MCFG), jmake_mesh(n), learning_rate=3e-3,
                                 sz=1)
    pj, oj = init_j({k: jnp.asarray(v) for k, v in _params(1).items()})
    _, _, lj = step_j(pj, oj, jnp.float32(0.25))
    assert abs(losses[0] - float(lj)) <= JAX_STEP_LOSS_REL * abs(float(lj))
