"""The float64 referee of the encoded-field gradients applied to the port
(the counterparts of tests/test_f64_encoded.py's 3 tests).

The JAX package's independent float64 replica of encode -> head ->
residuals -> loss (ref/f64_grad.f64_encoded_loss_and_grad) grades the
port's K5 route: on the CPU, K5's plain version (kernels/mega_ngp.
ngp_loss_and_grad on CPU params). It passes if its distance to the truth
is no worse than jax.grad's own times that file's slack (2.5 for the hash
encoding, 1.5 for Fourier), on the same params and grids. The referee is
imported from the JAX package here; nothing in the port imports it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import fourier as jfourier
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.ref.f64_grad import f64_encoded_loss_and_grad
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, PhysWeights, ops
from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_supported
from phys_autodiff_tpu_torch.models import ngp
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig

torch.set_num_threads(1)

W = PhysWeights(w_sigma=1.3, w_u=0.7)
JW = jconfig.PhysWeights(w_sigma=1.3, w_u=0.7)


def _jgrid(g):
    return jconfig.GridSpec(nx=g.nx, ny=g.ny, nz=g.nz, hx=g.hx, hy=g.hy, hz=g.hz, dt=g.dt, periodic=g.periodic,
                            scheme=g.scheme)


def _jcfg(fourier=False, **enc):
    """JAX's NGPFieldConfig() (or with a Fourier or another hash encoding)."""
    if fourier:
        return jngp.NGPFieldConfig(encoding=jfourier.FourierEncodingConfig())
    return jngp.NGPFieldConfig(encoding=jhash.HashEncodingConfig(**enc)) if enc else jngp.NGPFieldConfig()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    """The leaves in jax.tree_util's order (dict keys sorted: the port's
    trees flatten the same way), float64, concatenated."""
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(gp)])


def _conditioned_params(jcfg, seed=777, scale_tables=True):
    """tests/test_f64_encoded.py's conditioning: tables x 2000 (paper-init
    tables leave every gradient at the float32 noise floor) and random
    biases."""
    params = jngp.init_ngp_params(jcfg, seed=seed)
    rng = np.random.Generator(np.random.MT19937(21))
    if scale_tables:
        params["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, params["tables"])
    params["b1"] = jnp.asarray(rng.standard_normal(params["b1"].shape) * 0.3, jnp.float32)
    params["b2"] = jnp.asarray(rng.standard_normal(params["b2"].shape) * 0.3, jnp.float32)
    return params


def _adjudicate(g, tcfg, jcfg, jparams, t=0.25):
    """(staged loss err, port loss err, d_jax, d_port) against the f64 truth:
    jax.grad of the JAX staged pipeline and the port's K5 route, each from
    the same params."""
    jg = _jgrid(g)
    l64, gp64 = f64_encoded_loss_and_grad(jg, JW, jcfg, jparams, t)

    def staged_total(p, tt):
        return jops.total_loss(jg, JW, jngp.generate_fields(jg, jcfg, p, tt, jg.dt))

    l32, gp32 = jax.jit(jax.value_and_grad(staged_total))(jparams, jnp.float32(t))
    tparams = ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    lk, (gpk, _) = k5.ngp_loss_and_grad(g, W, tcfg, tparams, t)
    assert len(jax.tree_util.tree_leaves(gpk)) == len(jax.tree_util.tree_leaves(gp64))
    return (abs(float(l32) - l64) / abs(l64), abs(float(lk) - l64) / abs(l64),
            _rel(_cat(gp32), _cat(gp64)), _rel(_cat(gpk), _cat(gp64)))


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False])
def test_ngp_k5_no_worse_than_jax_grad_vs_f64_truth(scheme, periodic):
    g = GridSpec(nx=32, ny=16, nz=8, hx=1 / 32, hy=1 / 16, hz=1 / 8, dt=1e-3, periodic=periodic, scheme=scheme)
    assert ngp_supported(g)
    s_err, k_err, d_jax, d_port = _adjudicate(g, ngp.NGPFieldConfig(), _jcfg(), _conditioned_params(_jcfg()))
    # the referee itself sits at float32 distance from the staged arm
    assert s_err < 1e-4, s_err
    assert d_jax < 1e-2, d_jax
    # the loss within the float32 noise floor of the truth; the gradient's
    # distance to the truth in jax.grad's class, with that file's slack
    # (2.5: dEnc in H chunks pulled back through the encoder apart)
    assert k_err <= max(5.0 * s_err, 1e-6), (k_err, s_err)
    assert d_port <= max(2.5 * d_jax, 1e-6), (d_port, d_jax)
    assert d_port < 1e-4, d_port


def test_fourier_k5_no_worse_than_jax_grad_vs_f64_truth():
    g = GridSpec(nx=32, ny=16, nz=8, hx=1 / 32, hy=1 / 16, hz=1 / 8, dt=1e-3)
    jcfg = _jcfg(fourier=True)
    tcfg = ngp.NGPFieldConfig(encoding=FourierEncodingConfig())
    s_err, k_err, d_jax, d_port = _adjudicate(g, tcfg, jcfg, _conditioned_params(jcfg, scale_tables=False))
    assert s_err < 1e-4, s_err
    assert d_jax < 1e-2, d_jax
    assert k_err <= max(5.0 * s_err, 1e-6), (k_err, s_err)
    assert d_port <= max(1.5 * d_jax, 1e-6), (d_port, d_jax)


def test_f64_encoded_referee_grades_the_right_function():
    """Control: the referee's loss matches the port's staged float32 loss to
    float32 rounding, and a different encoding schedule is refused by both
    the referee and the port (the graded-the-wrong-function hazard)."""
    g = GridSpec(nx=16, ny=12, nz=6, hx=1 / 16, hy=1 / 12, hz=1 / 6, dt=1e-3)
    jparams = _conditioned_params(_jcfg(), seed=5)
    l64, _ = f64_encoded_loss_and_grad(_jgrid(g), JW, _jcfg(), jparams, 0.3)
    tparams = ngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    l32 = float(ops.total_loss(g, W, ngp.generate_fields(g, ngp.NGPFieldConfig(), tparams, 0.3, g.dt)))
    assert abs(l32 - l64) / abs(l64) < 1e-4
    wrong = dict(num_levels=4, dense_oversubscribed=True)
    with pytest.raises(Exception):
        f64_encoded_loss_and_grad(_jgrid(g), JW, _jcfg(**wrong), jparams, 0.3)
    with pytest.raises(Exception):
        k5.ngp_loss_and_grad(g, W, ngp.NGPFieldConfig(encoding=HashEncodingConfig(**wrong)), tparams, 0.3)
