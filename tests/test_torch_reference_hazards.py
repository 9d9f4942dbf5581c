"""Reference hazard R6 (ROADMAP.md): the JAX package's masked-CGNR gradient
diverges at 300 CG iterations, so the port is compared with it at 20.

The case is the JAX dry run's phase 10 (tests/test_torch_sharded_apps.py
`_masked_case`: a solid box, an emitter and a fan, 3 Euler steps) on one
device in float64, the loss a fixed weighted sum of the final sigma and u.
Both packages differentiate CG implicitly (phys_autodiff_tpu/ops/
projection.py:164, phys_autodiff_tpu_torch/ops/cg.py:67-78): the backward
solves the normal equations for a cotangent with a part outside their
range. At 20 iterations the two gradients agree to about 3e-9 / 6e-9
(relative L2; held at 1e-7, the masked rollout's gradient class of
tests/test_torch_sharded_apps.py); at 300 the reference's own gradient is
astronomically large (about 1e50). Only the reference's divergence is
pinned here; the port's own gradient at 300 iterations is an open question
(PERF.md section 7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from phys_autodiff_tpu.apps import euler as jeu
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch.apps import euler
from test_torch_sharded_apps import _masked_case, _weights

torch.set_num_threads(1)


def _case(maxiter):
    """Phase 10's masked case at cg_maxiter=maxiter and the loss's weights."""
    g, mask, src, st, cfg = _masked_case(True)
    cfg = dataclasses.replace(cfg, cg_maxiter=maxiter)
    ws = [_weights(st.sigma.shape, 1, torch.float64), _weights(st.u.shape, 2, torch.float64)]
    return g, mask, src, st, cfg, ws


def _port_gradient(maxiter):
    """The port's gradient in sigma0 and u0, float64 numpy."""
    g, mask, src, st, cfg, ws = _case(maxiter)
    s0, u0 = st.sigma.clone().requires_grad_(), st.u.clone().requires_grad_()
    fin, _ = euler.rollout(g, euler.EulerState(s0, u0), cfg, mask=mask, source=src)
    port = torch.autograd.grad(torch.sum(ws[0] * fin.sigma) + torch.sum(ws[1] * fin.u), [s0, u0])
    return [x.numpy() for x in port]


def _jax_gradient(maxiter):
    """JAX's gradient in sigma0 and u0 on the same inputs, float64 numpy."""
    g, mask, src, st, cfg, ws = _case(maxiter)
    with jax.enable_x64(True):
        jg = jconfig.GridSpec(nx=g.nx, ny=g.ny, nz=g.nz, hx=g.hx, hy=g.hy, hz=g.hz, dt=g.dt, periodic=g.periodic)
        jcfg = jeu.EulerConfig(dt=cfg.dt, steps=cfg.steps, buoyancy=cfg.buoyancy, cg_maxiter=maxiter)
        jm = jnp.asarray(mask.numpy())
        jsrc = jeu.EulerSource(jnp.asarray(src.sigma_rate.numpy()), jnp.asarray(src.force.numpy()))
        jw = [jnp.asarray(w.numpy()) for w in ws]

        def loss(s, u):
            f, _ = jeu.rollout(jg, jeu.EulerState(s, u), jcfg, mask=jm, source=jsrc)
            return jnp.sum(jw[0] * f.sigma) + jnp.sum(jw[1] * f.u)

        ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(st.sigma.numpy()), jnp.asarray(st.u.numpy()))
        return [np.asarray(x, np.float64) for x in ref]


def test_masked_cgnr_gradient_matches_jax_at_20_iterations():
    port, ref = _port_gradient(20), _jax_gradient(20)
    rel = [np.linalg.norm(a - b) / np.linalg.norm(b) for a, b in zip(port, ref)]
    print(f"R6 at 20 iterations: rel_l2 d/dsigma0 {rel[0]:.2e}, d/du0 {rel[1]:.2e}")
    assert max(rel) <= 1e-7, rel


def test_masked_cgnr_gradient_diverges_in_the_reference_at_300_iterations():
    """R6 pinned: JAX's own gradient is no referee at 300 iterations."""
    norms = [float(np.linalg.norm(x)) for x in _jax_gradient(300)]
    print(f"R6 at 300 iterations: JAX |d/dsigma0| {norms[0]:.2e}, |d/du0| {norms[1]:.2e}")
    assert all(not np.isfinite(n) or n > 1e30 for n in norms), norms
