"""The slab-recompute gradient and the fused loss's routing
(phys_autodiff_tpu_torch/train/slab_grad.py) vs the JAX package's
train/slab_grad.py and its staged jax.grad.

Ports tests/test_slab_grad.py. Tolerances are that file's (its docstring
says why): the slab gradient and the staged gradient are float32 programs
of the same math in different summation orders, so losses are held at
5e-6 relative, the gradient at 1e-4 relative L2 on the concatenation and
1e-3 per leaf, d_t at 3e-4 (F32_VS_ORACLE_RSIGMA_REL). The port's slab
gradient against JAX's is held to the same classes; the bf16 tier to
BF16_REL on the loss and 1e-3 per leaf.
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
from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.train import slab_grad as jsg
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.train import TrainConfig, fit, make_train_step, state_from_params
from phys_autodiff_tpu_torch.train import slab_grad as sg
from phys_autodiff_tpu_torch.utils import tolerances as tol

torch.set_num_threads(1)

GRID = dict(nx=16, ny=8, nz=12, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    return getattr(jconfig, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    return np.concatenate([np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)])


def _np(gp):
    return {k: v.detach().numpy() for k, v in gp.items()}


def _params(cfg, seed):
    jp = jmlp.init_params(_jax(cfg.dims), seed=seed)
    return jp, tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _staged(g, w, cfg, jp, t):
    def loss(p, tt):
        return jops.total_loss(_jax(g), _jax(w), jgenerate(_jax(g), _jax(cfg), p, tt, g.dt))

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(jp, jnp.float32(t))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne])
def test_slab_grad_matches_jax_grad(periodic, norm, precision):
    g = GridSpec(periodic=periodic, **GRID)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp, tp = _params(cfg, 3)
    t = 0.25
    l_s, (gp_s, gt_s) = sg.make_slab_loss_and_grad(g, w, cfg, sz=4, precision=precision)(tp, t)
    jl, (jgp, jgt) = jax.jit(jsg.make_slab_loss_and_grad(_jax(g), _jax(w), _jax(cfg), sz=4, precision=precision))(
        jp, jnp.float32(t)
    )
    if precision == "f32":
        l_ref, (gp_ref, gt_ref) = _staged(g, w, cfg, jp, t)
        assert abs(float(l_s) - float(l_ref)) / abs(float(l_ref)) < 5e-6
        assert _rel(_cat(_np(gp_s)), _cat(gp_ref)) < 1e-4
        for k in gp_ref:
            assert _rel(gp_s[k].numpy(), gp_ref[k]) < 1e-3, k
        assert abs(float(gt_s) - float(gt_ref)) / abs(float(gt_ref)) < tol.F32_VS_ORACLE_RSIGMA_REL
    loss_tol = 5e-6 if precision == "f32" else tol.BF16_REL
    assert abs(float(l_s) - float(jl)) / abs(float(jl)) < loss_tol
    assert _rel(_cat(_np(gp_s)), _cat(jgp)) < 1e-4
    for k in jgp:
        assert _rel(gp_s[k].numpy(), jgp[k]) < 1e-3, k
    assert abs(float(gt_s) - float(jgt)) / abs(float(jgt)) < tol.F32_VS_ORACLE_RSIGMA_REL


def test_slab_fields_match_staged_fields():
    """The rank-1 slab field generator gives the staged generator's fields on
    its rows (1e-6: the same math in another association), and JAX's
    slab_fields_rows (MLP_INFER_REL)."""
    g = GridSpec(**GRID)
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    jp, tp = _params(cfg, 5)
    t = 0.3
    fs = tfields.generate_fields(g, cfg, tp, t, g.dt)
    idx = torch.remainder(torch.arange(-1, 5), g.nz)
    ts = torch.tensor(np.asarray(tfields.slice_times(t, g.dt), np.float32))
    sigma, u = sg.slab_fields_rows(g, cfg, tp, ts, idx)
    ref_sigma = torch.stack([fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1])[:, idx]
    ref_u = torch.stack([fs.u_tm1, fs.u_t, fs.u_tp1])[:, :, idx]
    assert _rel(sigma.numpy(), ref_sigma.numpy()) < 1e-6
    assert _rel(u.numpy(), ref_u.numpy()) < 1e-6
    js, ju = jsg.slab_fields_rows(_jax(g), _jax(cfg), jp, jnp.asarray(ts.numpy()), jnp.asarray(idx.numpy()))
    assert _rel(sigma.numpy(), js) < tol.MLP_INFER_REL
    assert _rel(u.numpy(), ju) < tol.MLP_INFER_REL


def test_fused_loss_custom_vjp():
    """make_fused_loss(backward="slab"): the forward is the fused pipeline's
    loss, the gradients the slab gradients; against the JAX staged gradient
    and JAX's make_fused_loss(backward="slab") (3e-4 per leaf)."""
    g = GridSpec(**GRID)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    jp, tp = _params(cfg, 7)
    t = 0.25
    loss = sg.make_fused_loss(g, w, cfg, sz=4, backward="slab")
    with torch.enable_grad():
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        l = loss(p, t)
        grads = torch.autograd.grad(l, [p[k] for k in sorted(p)])
    l = l.detach()
    gp = dict(zip(sorted(p), grads))
    l_ref, (gp_ref, _) = _staged(g, w, cfg, jp, t)
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < 1e-5
    jl, jgp = jax.jit(jax.value_and_grad(jsg.make_fused_loss(_jax(g), _jax(w), _jax(cfg), sz=4, interpret=True,
                                                             backward="slab")))(jp, jnp.float32(t))
    assert abs(float(l) - float(jl)) / abs(float(jl)) < 1e-5
    for k in gp_ref:
        assert _rel(gp[k].numpy(), gp_ref[k]) < 3e-4, k
        assert _rel(gp[k].numpy(), jgp[k]) < 3e-4, k


def test_fused_train_step_matches_staged():
    """TrainConfig(use_fused=True) trains the trajectory of the staged step
    (the loss history within 1e-4 relative at every logged step), and of
    the JAX package's staged step; the loss decreases."""
    g = GridSpec(**GRID)
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    steps = 15
    hists = {}
    for fused in (False, True):
        cfg = TrainConfig(use_fused=fused, steps=steps, learning_rate=3e-3, log_every=5)
        _, hists[fused], _ = fit(g, w, mcfg, cfg, device="cpu")
    jcfg = jloop.TrainConfig(use_fused=False, steps=steps, learning_rate=3e-3, log_every=5)
    _, jhist, _ = jloop.fit(_jax(g), _jax(w), _jax(mcfg), jcfg)
    for (s0, l0), (s1, l1), (sj, lj) in zip(hists[False], hists[True], jhist):
        assert s0 == s1 == sj
        assert abs(l0 - l1) / max(abs(l0), 1e-12) < 1e-4
        assert abs(lj - l1) / max(abs(lj), 1e-12) < 1e-4
    assert hists[True][-1][1] < hists[True][0][1]


def test_pick_slab_rows_divides():
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    for h in (32, 128, 1400):
        sz = sg.pick_slab_rows(g, h=h)
        assert g.nz % sz == 0 and sz >= 1
        assert sz == jsg.pick_slab_rows(_jax(g), h=h)


def test_slab_grad_large_virtual_grid_compiles():
    """Many slabs (sz = 2 of nz = 16) on a 64x32x16 grid: finite, and the
    loss and gradient of JAX's slab gradient."""
    g = GridSpec(nx=64, ny=32, nz=16, hx=0.1, hy=0.1, hz=0.1, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    jp, tp = _params(cfg, 1)
    l, (gp, _) = sg.make_slab_loss_and_grad(g, PhysWeights(), cfg, sz=2)(tp, 0.1)
    assert np.isfinite(float(l))
    assert all(torch.isfinite(v).all() for v in gp.values())
    jl, (jgp, _) = jax.jit(jsg.make_slab_loss_and_grad(_jax(g), jconfig.PhysWeights(), _jax(cfg), sz=2))(
        jp, jnp.float32(0.1)
    )
    assert abs(float(l) - float(jl)) / abs(float(jl)) < 5e-6
    assert _rel(_cat(_np(gp)), _cat(jgp)) < 1e-4


@pytest.mark.parametrize("h,tier,backward", [(1400, "f32", "slab"), (1300, "f32", "mega"), (1400, "bf16", "slab"),
                                             (1340, "bf16", "mega")])
def test_fused_step_above_k4_gate_takes_the_slab_backward(monkeypatch, h, tier, backward):
    """make_train_step(use_fused=True) past K4's gate of its tier (f32
    H <= 1300, bf16 H <= 1360) runs the fused loss, whose backward is the
    slab-recompute gradient, and does not raise; within the gate the step
    takes K4 in one call. Recorders stand in for K4's entry points."""
    from phys_autodiff_tpu_torch.train import loop as tloop

    calls = []
    slab = sg.make_slab_loss_and_grad

    def k4(g, w, mcfg, params, t, precision):
        calls.append(("mega", precision))
        return torch.zeros(()), ({k: torch.zeros_like(v) for k, v in params.items()}, torch.zeros(()))

    def recorded_slab(g, w, mcfg, sz=None, precision="f32"):
        calls.append(("slab", precision))
        return slab(g, w, mcfg, sz, precision)

    monkeypatch.setattr(tloop, "mega_loss_and_grad", k4)
    monkeypatch.setattr(sg, "mega_loss_and_grad", k4)
    monkeypatch.setattr(sg, "make_slab_loss_and_grad", recorded_slab)
    g = GridSpec(nx=8, ny=4, nz=4, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    tcfg = TrainConfig(use_fused=True, precision=tier, learning_rate=1e-3)
    state = state_from_params(tcfg, tmlp.init_params(cfg.dims, seed=0, device="cpu"))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss = make_train_step(g, PhysWeights(), cfg, tcfg)(state)
    assert calls == [(backward, tier)]
    assert np.isfinite(float(loss))
    if backward == "slab":
        assert sg.uses_mega_backward(g, cfg, tier) is False
        assert any(not torch.equal(before[k], state.params[k]) for k in before)
