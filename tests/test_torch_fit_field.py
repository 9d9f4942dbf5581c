"""Supervised field fitting (phys_autodiff_tpu_torch/train/fit_field.py) vs the
JAX package's train/fit_field.py.

Both packages start from bitwise-equal seeded params (init_any) and the same
numpy targets. The port's engine="mega" runs the plain versions of K6 / K7
(and of K4 / K5 for the physics term) on the CPU; engine="xla" is autograd
of the staged loss. Five-step trajectories are held to the JAX fit_field at
the tolerances of tests/test_fit_kernel.py:107-110 (losses 1e-5 relative,
params 2e-4 relative, atol 1e-6, leaf by leaf) and :309-315 (the NGP with
the composite: losses 2e-5, the flattened params 3e-4 relative L2); the
composite MLP at :129-134 (losses 2e-5, params 3e-4).
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.train import fit_field as jff
from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.models import ngp
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.train import TrainConfig
from phys_autodiff_tpu_torch.train import fit_field as ff
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

_JAX_MODULES = (jconfig, jhash, jfourier, jngp, jloop)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes and enums)."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


G = GridSpec(nx=16, ny=8, nz=6, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
MLP_CFG = MLPGridConfig(dims=MLPDims(H=8))
NGP_CFG = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=3, features_per_level=2, log2_table_size=9,
                                                         base_resolution=3, max_resolution=12), hidden=16)


def _targets(g, seeds=(3,), ts=(0.3,)):
    out = []
    for seed, t in zip(seeds, ts):
        rng = np.random.default_rng(seed)
        out.append((rng.normal(size=g.shape).astype(np.float32),
                    (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32), t))
    return out


def _port_targets(targets):
    return [ff.target_from_arrays(s, u, t, device="cpu") for s, u, t in targets]


def _jax_targets(targets):
    return [jff.target_from_arrays(s, u, t) for s, u, t in targets]


def _params_close_leafwise(port, ref, rtol, atol):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = tree.leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _flat_rel(port, ref):
    a = np.concatenate([x.numpy().ravel() for x in tree.leaves(port)])
    b = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(ref)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------- trajectories


@pytest.mark.parametrize("engine", ["mega", "xla"])
def test_mlp_fit_trajectory_matches_jax(engine):
    targets = _targets(G)
    cfg = TrainConfig(steps=5, learning_rate=1e-3, seed=2)
    pp, lp = ff.fit_field(G, MLP_CFG, _port_targets(targets), cfg, engine=engine, device="cpu")
    jp, lj = jff.fit_field(_jax(G), _jax(MLP_CFG), _jax_targets(targets), _jax(cfg), engine="xla")
    assert tuple(lp.shape) == (5,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-5)
    _params_close_leafwise(pp, jp, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ["mega", "xla"])
def test_ngp_fit_trajectory_matches_jax(engine):
    targets = _targets(G, seeds=(8,))
    cfg = TrainConfig(steps=5, learning_rate=3e-3, seed=5)
    pp, lp = ff.fit_field(G, NGP_CFG, _port_targets(targets), cfg, engine=engine, device="cpu")
    jp, lj = jff.fit_field(_jax(G), _jax(NGP_CFG), _jax_targets(targets), _jax(cfg), engine="xla")
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=2e-5)
    assert _flat_rel(pp, jp) < 3e-4


@pytest.mark.parametrize("family", ["mlp", "ngp"])
def test_composite_multi_snapshot_fit_matches_jax(family):
    """The PINN composite (phys_weight > 0: K4 / K5's plain versions beside
    K6 / K7's) over two snapshots, with a global-norm clip and a cosine
    schedule with warmup, against the JAX composite (engine="xla")."""
    mcfg = MLP_CFG if family == "mlp" else NGP_CFG
    targets = _targets(G, seeds=(5, 6), ts=(0.2, 0.45))
    cfg = TrainConfig(steps=5, learning_rate=3e-3, seed=4, grad_clip=0.5, lr_schedule="cosine", warmup_steps=2)
    pm, lm = ff.fit_field(G, mcfg, _port_targets(targets), cfg, phys_weight=0.3, engine="mega", device="cpu")
    jp, lj = jff.fit_field(_jax(G), _jax(mcfg), _jax_targets(targets), _jax(cfg), phys_weight=0.3, engine="xla")
    np.testing.assert_allclose(lm.numpy(), np.asarray(lj), rtol=2e-5)
    assert _flat_rel(pm, jp) < 3e-4
    px, lx = ff.fit_field(G, mcfg, _port_targets(targets), cfg, phys_weight=0.3, engine="xla", device="cpu")
    np.testing.assert_allclose(lx.numpy(), np.asarray(lj), rtol=2e-5)


def test_fit_runs_from_given_params_and_leaves_them_alone():
    targets = _port_targets(_targets(G))
    p0 = ff.init_any(MLP_CFG, seed=9, device="cpu")
    before = {k: v.clone() for k, v in p0.items()}
    p1, _ = ff.fit_field(G, MLP_CFG, targets, TrainConfig(steps=2, seed=0), params0=p0, engine="mega",
                         device="cpu")
    for k in p0:
        assert torch.equal(p0[k], before[k]) and not torch.equal(p1[k], before[k])
        assert not p1[k].requires_grad


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("family", ["mlp", "ngp"])
def test_data_loss_and_snapshots_match_jax(family):
    mcfg = MLP_CFG if family == "mlp" else NGP_CFG
    params = ff.init_any(mcfg, seed=3, device="cpu")
    jparams = jff.init_any(_jax(mcfg), seed=3)
    for a, b in zip(tree.leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (s, u, t), = _targets(G)
    w = PhysWeights(w_sigma=1.2, w_u=0.7)
    port = ff.data_loss(G, mcfg, params, ff.target_from_arrays(s, u, t, device="cpu"), w)
    ref = jff.data_loss(_jax(G), _jax(mcfg), jparams, jff.target_from_arrays(s, u, t), _jax(w))
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-6)
    fs = ff.snapshots_from_model(G, mcfg, params, 0.3)
    jfs = jff.snapshots_from_model(_jax(G), _jax(mcfg), jparams, 0.3)
    for a, b in zip(fs, jfs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_resolve_fit_engine():
    assert ff._resolve_fit_engine("xla", G, MLP_CFG, 0.0) == "xla"
    assert ff._resolve_fit_engine("mega", G, MLP_CFG, 0.0) == "mega"
    assert ff._resolve_fit_engine("auto", G, MLP_CFG, 0.0) == "xla"  # params on the CPU
    assert ff._resolve_fit_engine("auto", G, MLP_CFG, 0.5, on_card=True) == "mega"
    ragged = GridSpec(nx=10, ny=10, nz=3)  # the JAX kernels' gate refuses it; the port's takes it
    assert ff._resolve_fit_engine("mega", ragged, NGP_CFG, 0.1) == "mega"
    with pytest.raises(ValueError, match="mega"):
        ff._resolve_fit_engine("mega", G, MLPGridConfig(dims=MLPDims(H=5000)), 0.0)
    with pytest.raises(ValueError, match="mega"):
        ff._resolve_fit_engine("mega", G, ngp.NGPFieldConfig(out=3), 0.0)
    with pytest.raises(ValueError, match="unknown fit engine"):
        ff._resolve_fit_engine("fast", G, MLP_CFG, 0.0)


def test_mega_engine_on_cpu_params_launches_nothing():
    _build.reset_launches()
    ff.fit_field(G, NGP_CFG, _port_targets(_targets(G)), TrainConfig(steps=1), phys_weight=0.2, engine="mega",
                 device="cpu")
    assert all(v == 0 for v in _build.LAUNCHES.values())


# ---------------------------------------------------------------- the report


def test_psnr_compression_and_report_match_jax():
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(4, 5, 6)).astype(np.float32)
    pred = ref + 0.01 * rng.normal(size=ref.shape).astype(np.float32)
    np.testing.assert_allclose(float(ff.psnr(torch.tensor(pred), torch.tensor(ref))),
                               float(jff.psnr(jnp.asarray(pred), jnp.asarray(ref))), rtol=1e-6)
    assert float(ff.psnr(torch.tensor(ref), torch.tensor(ref))) > 250.0  # mse floored at 1e-30
    for mcfg in (MLP_CFG, NGP_CFG):
        params = ff.init_any(mcfg, seed=0, device="cpu")
        jparams = jff.init_any(_jax(mcfg), seed=0)
        assert ff.compression_stats(params, G, 3) == jff.compression_stats(jparams, _jax(G), 3)
        targets = _targets(G, seeds=(1, 2), ts=(0.1, 0.6))
        port = ff.fit_report(G, mcfg, params, _port_targets(targets))
        jrep = jff.fit_report(_jax(G), _jax(mcfg), jparams, _jax_targets(targets))
        assert port.keys() == jrep.keys()
        for a, b in zip(port["snapshots"], jrep["snapshots"]):
            assert a.keys() == b.keys() and a["t"] == b["t"]
            for k in ("psnr_sigma_db", "psnr_u_db"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
        for k in ("param_bytes", "raw_bytes", "compression_ratio"):
            assert port[k] == jrep[k]
