"""K3 (phys_autodiff_tpu_torch/kernels/mega.py) vs the JAX mega-kernel and
the JAX staged pipeline (the grid of tests/test_mega.py:21).

On the CPU the port runs the kernel's plain version (table MLP -> staged
residuals -> plane partials -> fixed-order sum); the JAX mega-kernel runs
in interpret mode. Tolerance 1e-5 relative, as tests/test_mega.py holds
mega against staged (the MLP's summation order differs between arms).
"""

import dataclasses

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
from phys_autodiff_tpu_torch.kernels import mega as kmega
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.kernels import residuals as kres
from phys_autodiff_tpu_torch.models import mlp as tmlp

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
