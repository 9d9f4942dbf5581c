"""The fluid ops of the port (phys_autodiff_tpu_torch/ops/{diagnostics,
projection,diffusion,obstacles,cg}.py) against the JAX package's ops.

The same numpy inputs go through both packages. Limits: stencil-only ops
1e-6 relative to the field's max; the FFT paths 1e-5 relative to the field's
max; the CG / CGNR paths 1e-4 relative, and the same iteration count where
the stopping rule fires; masks exact. CGNR runs 20 iterations: on a rough
right-hand side its float32 iterates part after about 25 (JAX's own
project_cg at 30 iterations moves by 2e-3 of the field under a 1e-7
relative change of its input), so 30 would compare rounding, not code.
"""

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.ops import diagnostics as jdiag
from phys_autodiff_tpu.ops import diffusion as jdiff
from phys_autodiff_tpu.ops import obstacles as jobs
from phys_autodiff_tpu.ops import projection as jproj
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec
from phys_autodiff_tpu_torch.ops import cg as cg_mod
from phys_autodiff_tpu_torch.ops import diagnostics, diffusion, obstacles, projection

torch.set_num_threads(1)


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    return getattr(jconfig, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _grid(periodic, dims=(16, 12, 8)):
    return GridSpec(*dims, hx=0.5, hy=0.25, hz=0.4, dt=1e-3, periodic=periodic)


def _fields(g, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=g.shape).astype(np.float32), rng.normal(size=(3,) + g.shape).astype(np.float32)


def _rel_close(port, ref, limit):
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(port - ref).max()) <= limit * scale, float(np.abs(port - ref).max()) / scale


CGNR_ITERS = 20
BOTH = pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])


@BOTH
@pytest.mark.parametrize("dims", [(16, 12, 8), (9, 6, 1)])
def test_diagnostics_match_jax(periodic, dims):
    g = _grid(periodic, dims)
    jg = _jax(g)
    sigma, u = _fields(g)
    ut = torch.tensor(u)
    _rel_close(diagnostics.divergence(g, ut), jdiag.divergence(jg, u), 1e-6)
    _rel_close(diagnostics.curl(g, ut), jdiag.curl(jg, u), 1e-6)
    np.testing.assert_allclose(float(diagnostics.kinetic_energy(ut)), float(jdiag.kinetic_energy(u)), rtol=1e-6)
    stats = diagnostics.field_stats(g, torch.tensor(sigma), ut)
    jstats = jdiag.field_stats(jg, sigma, u)
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-6)
    _rel_close(projection.grad(g, torch.tensor(sigma)), jproj.grad(jg, sigma), 1e-6)
    _rel_close(projection.velocity_from_potential(g, ut), jproj.velocity_from_potential(jg, u), 1e-6)
    np.testing.assert_allclose(float(projection.projection_residual(g, ut)),
                               float(jproj.projection_residual(jg, u)), rtol=1e-6)
    _rel_close(diffusion.laplacian(g, ut), jdiff.laplacian(jg, u), 1e-6)


@pytest.mark.parametrize("dims", [(16, 12, 8), (8, 9, 6), (7, 5, 1)])
def test_spectral_symbols_are_the_jax_symbols(dims):
    g = _grid(True, dims)
    for a, b in zip(projection._central_symbols(g), jproj._central_symbols(_jax(g))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(diffusion._compact_symbol(g).numpy(), np.asarray(jdiff._compact_symbol(_jax(g))))


@pytest.mark.parametrize("dims", [(16, 12, 8), (9, 6, 1)])
def test_fft_paths_match_jax(dims):
    g = _grid(True, dims)
    jg = _jax(g)
    sigma, u = _fields(g, 1)
    out = projection.project_fft(g, torch.tensor(u))
    _rel_close(out, jproj.project_fft(jg, u), 1e-5)
    assert float(projection.projection_residual(g, out)) <= 1e-5 * float(out.abs().max())
    _rel_close(projection.project(g, torch.tensor(u)), jproj.project(jg, u), 1e-5)
    for f in (sigma, u):
        _rel_close(diffusion.diffuse_fft(g, torch.tensor(f), 0.3, 0.05), jdiff.diffuse_fft(jg, f, 0.3, 0.05), 1e-5)
        _rel_close(diffusion.diffuse(g, torch.tensor(f), 0.3, 0.05), jdiff.diffuse(jg, f, 0.3, 0.05), 1e-5)
    st = torch.tensor(sigma)
    assert diffusion.diffuse(g, st, 0.0, 0.05) is st  # c == 0: the identity


@BOTH
def test_cgnr_projection_matches_jax(periodic):
    g = _grid(periodic)
    _, u = _fields(g, 2)
    ref = jax.jit(functools.partial(jproj.project_cg, _jax(g), maxiter=CGNR_ITERS))(u)
    _rel_close(projection.project_cg(g, torch.tensor(u), maxiter=CGNR_ITERS), ref, 1e-4)
    if not periodic:  # the dispatch takes CGNR under clamp
        _rel_close(projection.project(g, torch.tensor(u), maxiter=CGNR_ITERS), ref, 1e-4)


@BOTH
def test_diffuse_cg_matches_jax_and_stops_at_the_same_iteration(periodic):
    """The stopping rule fires within maxiter here: the port's iteration
    count k is JAX's (JAX's result at maxiter=k equals its converged result,
    at maxiter=k-1 it does not)."""
    g = _grid(periodic)
    jg = _jax(g)
    _, u = _fields(g, 3)
    c, dt, tol_ = 0.02, 0.05, 1e-5
    out = diffusion.diffuse_cg(g, torch.tensor(u), c, dt, maxiter=30, tol=tol_)
    ref = jdiff.diffuse_cg(jg, u, c, dt, maxiter=30, tol=tol_)
    _rel_close(out, ref, 1e-4)
    cdt = float(np.float32(c) * np.float32(dt))
    _, k = cg_mod.cg(lambda x: x - cdt * diffusion.laplacian(g, x), torch.tensor(u), x0=torch.tensor(u), tol=tol_,
                     maxiter=30)
    k = int(k)
    assert 2 <= k < 30, k
    at_k = np.asarray(jdiff.diffuse_cg(jg, u, c, dt, maxiter=k, tol=tol_))
    np.testing.assert_array_equal(at_k, np.asarray(ref))
    assert not np.array_equal(np.asarray(jdiff.diffuse_cg(jg, u, c, dt, maxiter=k - 1, tol=tol_)), at_k)
    if not periodic:
        _rel_close(diffusion.diffuse(g, torch.tensor(u), c, dt, maxiter=30, tol=tol_),
                   jdiff.diffuse(jg, u, c, dt, maxiter=30, tol=tol_), 1e-4)


def test_cg_gradient_is_jaxs_implicit_gradient():
    """Differentiating a CG solve: the cotangent of b is a second CG solve
    (jax.scipy.sparse.linalg.cg's implicit rule, x0 included), not the
    unrolled iteration."""
    g = _grid(False)
    _, u = _fields(g, 4)
    w = np.random.default_rng(5).normal(size=(3,) + g.shape).astype(np.float32)
    c, dt = 0.5, 0.05
    jgrad = jax.grad(lambda f: jnp.sum(jdiff.diffuse_cg(_jax(g), f, c, dt, maxiter=30) * w))(jnp.asarray(u))
    ut = torch.tensor(u).requires_grad_()
    (tgrad,) = torch.autograd.grad(torch.sum(diffusion.diffuse_cg(g, ut, c, dt, maxiter=30) * torch.tensor(w)), [ut])
    _rel_close(tgrad, jgrad, 1e-4)


@BOTH
def test_masks_and_masked_projection_match_jax(periodic):
    g = _grid(periodic)
    jg = _jax(g)
    box = obstacles.box_mask(g, (2, 3, 4), (5, 7, 9), device="cpu")
    sphere = obstacles.sphere_mask(g, (4, 6, 8), 1.1, device="cpu")
    np.testing.assert_array_equal(box.numpy(), np.asarray(jobs.box_mask(jg, (2, 3, 4), (5, 7, 9))))
    np.testing.assert_array_equal(sphere.numpy(), np.asarray(jobs.sphere_mask(jg, (4, 6, 8), 1.1)))
    m = obstacles.union(box, sphere)
    jm = jobs.union(jobs.box_mask(jg, (2, 3, 4), (5, 7, 9)), jobs.sphere_mask(jg, (4, 6, 8), 1.1))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(obstacles.complement(m).numpy(), np.asarray(jobs.complement(jm)))
    assert obstacles.validate_mask(g, m).dtype == torch.float32
    with pytest.raises(ValueError, match="0/1"):
        obstacles.validate_mask(g, m * 0.5)
    with pytest.raises(ValueError, match="shape"):
        obstacles.validate_mask(g, m[:-1])
    sigma, u = _fields(g, 6)
    np.testing.assert_array_equal(obstacles.apply_no_slip(torch.tensor(u), m).numpy(),
                                  np.asarray(jobs.apply_no_slip(u, jm)))
    np.testing.assert_array_equal(obstacles.apply_no_slip(torch.tensor(sigma), m).numpy(),
                                  np.asarray(jobs.apply_no_slip(sigma, jm)))
    for axis in range(3):
        for off in (-1, 1):
            np.testing.assert_array_equal(obstacles._shift_clamp(torch.tensor(sigma), off, axis).numpy(),
                                          np.asarray(jobs._shift_clamp(sigma, off, axis)))
    out = obstacles.project_masked(g, torch.tensor(u), m, maxiter=CGNR_ITERS)
    _rel_close(out, jax.jit(functools.partial(jobs.project_masked, jg, maxiter=CGNR_ITERS))(u, jm), 1e-4)
    assert float(out[:, m == 0].abs().max()) == 0.0  # no-slip survives the projection
    np.testing.assert_allclose(float(obstacles.fluid_divergence(g, out, m)),
                               float(jobs.fluid_divergence(jg, np.asarray(out.numpy()), jm)), rtol=1e-5)
