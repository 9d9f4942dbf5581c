"""Divergence-free velocity projection (port of
phys_autodiff_tpu/ops/projection.py).

"Divergence-free" means that ops.diagnostics.divergence, the residual
operator's central-difference div, returns ~0. Three surfaces:

  * project_fft(g, u): periodic boxes. The Helmholtz projection solved in
    one shot in Fourier space with the exact symbol of the wide central
    difference (D_a e^{i k a} = i sin(k h_a)/h_a); the projected field's
    discrete divergence is zero to float rounding at every mode.
    torch.fft.rfftn / irfftn: the JAX package leaves its FFTs to XLA,
    outside any Pallas kernel.
  * project_cg(g, u, ...): clamp boxes. CGNR (CG on the normal equations
    A^T A p = A^T d, A = div(grad .) with the boundary-exact stencils); A^T
    is the VJP of the linear operator, taken once and reused.
  * velocity_from_potential(g, A): u = curl A, divergence-free in both
    boundary modes (shifts along different axes commute).

Plain PyTorch on the framework layout (u channel-major [3, nz, ny, nx]),
differentiable by autograd (CG by implicit differentiation, ops/cg.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from phys_autodiff_tpu_torch.ops.cg import cg
from phys_autodiff_tpu_torch.ops.diagnostics import curl, divergence
from phys_autodiff_tpu_torch.ops.stencil import central_diff, inv2h_f32
from phys_autodiff_tpu_torch.utils.config import GridSpec

_AX_Z, _AX_Y, _AX_X = 0, 1, 2


def grad(g: GridSpec, p: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient of a scalar: [3, nz, ny, nx]."""
    per = g.periodic
    return torch.stack(
        [
            central_diff(p, _AX_X, inv2h_f32(g.hx), per),
            central_diff(p, _AX_Y, inv2h_f32(g.hy), per),
            central_diff(p, _AX_Z, inv2h_f32(g.hz), per),
        ]
    )


@functools.lru_cache(maxsize=32)
def _central_symbols_np(g: GridSpec):
    # sin must be EXACTLY zero at k = 0 and the Nyquist k = n/2 (sin(pi) ~
    # 1e-16 in floating point would leak a ~1e32-amplified checkerboard
    # into p and destroy the solve in f32), so mask on 2k % n == 0.
    def s_of(k, n, h):
        k = np.rint(k).astype(np.int64)
        s = np.sin(2.0 * np.pi * k / n) / h
        return np.where((2 * k) % n == 0, 0.0, s)

    sz = s_of(np.fft.fftfreq(g.nz) * g.nz, g.nz, g.hz)
    sy = s_of(np.fft.fftfreq(g.ny) * g.ny, g.ny, g.hy)
    sx = s_of(np.fft.rfftfreq(g.nx) * g.nx, g.nx, g.hx)
    return sz.astype(np.float32), sy.astype(np.float32), sx.astype(np.float32)


def _central_symbols(g: GridSpec, device=None):
    """sin-symbols of the wide central difference per axis (computed in
    float64, cast to float32), broadcastable over the rfftn spectrum of a
    [nz, ny, nx] field (x axis halved)."""
    sz, sy, sx = (torch.as_tensor(s, device=device) for s in _central_symbols_np(g))
    return sz[:, None, None], sy[None, :, None], sx[None, None, :]


def project_fft(g: GridSpec, u: torch.Tensor) -> torch.Tensor:
    """Exact discrete Helmholtz projection on a periodic grid: u - grad p with
    lap p = div u solved spectrally under the wide central-difference
    symbol. Idempotent; differentiable."""
    assert g.periodic, "project_fft requires periodic boundaries; use project_cg"
    assert tuple(u.shape) == (3,) + g.shape, (u.shape, g.shape)
    d = divergence(g, u)
    d_hat = torch.fft.rfftn(d, dim=(0, 1, 2))
    sz, sy, sx = _central_symbols(g, u.device)
    lap = -(sx * sx + sy * sy + sz * sz)  # symbol of div(grad .)
    nonzero = lap != 0.0
    p_hat = torch.where(nonzero, d_hat / torch.where(nonzero, lap, torch.ones_like(lap)),
                        torch.zeros((), dtype=d_hat.dtype, device=u.device))
    p = torch.fft.irfftn(p_hat, s=g.shape, dim=(0, 1, 2)).to(u.dtype)
    return u - grad(g, p)


def _div_grad(g: GridSpec, p: torch.Tensor) -> torch.Tensor:
    """The discrete Poisson operator div(grad p) with the boundary-exact
    stencils (the operator the projection inverts)."""
    return divergence(g, grad(g, p))


def normal_solve(fwd, d: torch.Tensor, *, maxiter: int, tol: float) -> torch.Tensor:
    """argmin_p |fwd(p) - d|^2 for a linear `fwd` by CGNR: CG on
    A^T A p = A^T d, A^T the VJP of fwd (taken once, at zero, and reused).
    Shared by project_cg and ops.obstacles.project_masked."""
    _, vjp = torch.func.vjp(fwd, torch.zeros_like(d))

    def normal_op(p):
        (atap,) = vjp(fwd(p))
        return atap

    (rhs,) = vjp(d)
    p, _ = cg(normal_op, rhs, tol=tol, maxiter=maxiter)
    return p


def project_cg(g: GridSpec, u: torch.Tensor, *, maxiter: int = 200, tol: float = 1e-6) -> torch.Tensor:
    """Iterative Helmholtz projection for clamp (or periodic) boundaries:
    div(grad p) = div u in the least-squares sense by CGNR. Reduces the
    discrete divergence to the operator's attainable range (not exact like
    the FFT path)."""
    assert tuple(u.shape) == (3,) + g.shape, (u.shape, g.shape)
    d = divergence(g, u)
    d = d - torch.mean(d)
    p = normal_solve(functools.partial(_div_grad, g), d, maxiter=maxiter, tol=tol)
    return u - grad(g, p)


def project(g: GridSpec, u: torch.Tensor, *, maxiter: int = 200, tol: float = 1e-6) -> torch.Tensor:
    """Boundary-aware dispatch: FFT on periodic grids, CGNR on clamp grids."""
    if g.periodic:
        return project_fft(g, u)
    return project_cg(g, u, maxiter=maxiter, tol=tol)


def velocity_from_potential(g: GridSpec, A: torch.Tensor) -> torch.Tensor:
    """u = curl A, identically divergence-free in both boundary modes.
    A: [3, nz, ny, nx] -> u: [3, nz, ny, nx]."""
    assert tuple(A.shape) == (3,) + g.shape, (A.shape, g.shape)
    return curl(g, A)


def projection_residual(g: GridSpec, u: torch.Tensor) -> torch.Tensor:
    """max |div u|, the scalar a projection drives to zero (0-dim tensor)."""
    return torch.max(torch.abs(divergence(g, u)))
