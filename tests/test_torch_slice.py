"""The forward slice of the port end to end vs the JAX package, at a small
size: the three user entry points that the slice covers.

  * the README quick start: generate_fields_fused -> residuals_fused ->
    ops.loss_terms;
  * fused_loss_pipeline (K2 -> K1 partials) and mega_loss_pipeline (K3);
  * the bench headline op: residuals_fused_packed on K2's packed fields.

Parameters cross through params_from_jax. Each arm agrees with the JAX
arm at 1e-5 (mega vs staged, tests/test_mega.py:46) and with the f64
oracle on the port's own fields at 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.pallas import residuals as jres
from phys_autodiff_tpu.pallas.mlp import generate_fields_fused as jgenerate_fused
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch import ops as tops
from phys_autodiff_tpu_torch.kernels import (
    fused_loss_pipeline,
    generate_fields_fused,
    generate_fields_fused_packed,
    mega_loss_pipeline,
    pack_fields,
    residuals_fused,
    residuals_fused_packed,
)
from phys_autodiff_tpu_torch.models import generate_fields, mlp as tmlp
from phys_autodiff_tpu_torch.ref import oracle
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

torch.set_num_threads(1)

W = PhysWeights()


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
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize(
    "norm, periodic, scheme",
    [(CoordNorm.MinusOneToOne, True, "central"), (CoordNorm.ZeroToOne, False, "upwind")],
    ids=["m11-periodic-central", "z01-clamp-upwind"],
)
def test_slice_matches_jax_and_the_oracle(norm, periodic, scheme):
    # spacings of tests/test_mega.py: at dt=1e-3 the 1/(2 dt) time difference
    # amplifies last-ulp field differences between the staged (x @ W1) and
    # folded (AB + CD) layer 1 past 1e-5 on a grid this small
    g = GridSpec(nx=128, ny=8, nz=4, hx=0.3, hy=0.3, hz=0.3, dt=1e-2,
                 periodic=periodic, scheme=scheme)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    jp = jmlp.init_params(_jax(cfg.dims), seed=777)
    tp = tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")

    # README quick start, both packages
    fs_t = generate_fields_fused(g, cfg, tp, 0.25)
    ls_t, lu_t = tops.loss_terms(g, W, *residuals_fused(g, fs_t))
    fs_j = jgenerate_fused(_jax(g), _jax(cfg), jp, 0.25)
    ls_j, lu_j = jops.loss_terms(_jax(g), _jax(W), *jres.residuals_fused(_jax(g), fs_j))
    assert _rel(ls_t, ls_j) <= 1e-5 and _rel(lu_t, lu_j) <= 1e-5

    # the f64 oracle on the port's fields
    ls_o, lu_o = oracle.loss_forward(g, W, *[x.numpy() for x in fs_t])
    fused = fused_loss_pipeline(g, W, cfg, tp, 0.25)
    mega = mega_loss_pipeline(g, W, cfg, tp, 0.25)
    for arm in ((ls_t, lu_t), fused, mega):
        assert _rel(arm[0], ls_o) <= 1e-6 and _rel(arm[1], lu_o) <= 1e-6

    # the plain (staged) path agrees with the kernels' arms
    plain = tops.loss_forward(g, W, generate_fields(g, cfg, tp, 0.25, g.dt))
    for arm in (fused, mega):
        assert _rel(arm[0], plain[0]) <= 1e-5 and _rel(arm[1], plain[1]) <= 1e-5

    # the bench headline op on K2's packed output
    packed = generate_fields_fused_packed(g, cfg, tp, 0.25)
    out_t = residuals_fused_packed(g, packed)
    np.testing.assert_array_equal(packed.numpy(), pack_fields(fs_t).numpy())
    # (same fields into the Pallas kernel: the residual amplifies last-ulp
    # field differences by 1/(2 dt), so the arms are compared on one input)
    out_j = jres.residuals_fused_packed(_jax(g), jnp.asarray(packed.numpy()), True)
    assert rel_l2_err(out_t.numpy(), np.asarray(out_j)) <= tol.FUSED_VS_STAGED_REL


def test_fields_feed_the_kernels_without_copies():
    """K2's outputs are the contiguous channel planes K1 takes as-is."""
    g = GridSpec(nx=16, ny=8, nz=3, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=8))
    tp = tmlp.init_params(cfg.dims, seed=1, device="cpu")
    packed = generate_fields_fused_packed(g, cfg, tp, 0.1)
    assert packed.is_contiguous() and all(packed[i].is_contiguous() for i in range(12))
