"""Implicit diffusion, the "diffuse" stage of the stable-fluids update (port
of phys_autodiff_tpu/ops/diffusion.py).

Solve (I - c dt L) f_new = f, unconditionally stable at any c and dt. L is
the COMPACT 7-point Laplacian (f[i+1] - 2 f[i] + f[i-1])/h^2 per axis, not
div(grad .) of the wide stencil, which annihilates the Nyquist mode and would
leave checkerboard noise undamped.

  * diffuse_fft: periodic, one-shot exact inversion in Fourier space,
    1/(1 + c dt 4 sum_a sin^2(pi k_a/n_a)/h_a^2);
  * diffuse_cg: clamp, CG on the symmetric positive definite (I - c dt L),
    warm-started at f;
  * diffuse: the boundary-aware dispatch.

Both act on [nz, ny, nx] scalars or [3, nz, ny, nx] vectors (the spatial
axes are the trailing three), conserve the mean, and are differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from phys_autodiff_tpu_torch.ops.cg import cg
from phys_autodiff_tpu_torch.ops.stencil import shift
from phys_autodiff_tpu_torch.utils.config import GridSpec

_SPATIAL = (-3, -2, -1)  # z, y, x always ride the trailing axes


def laplacian(g: GridSpec, f: torch.Tensor) -> torch.Tensor:
    """Compact 7-point Laplacian sum_a (f[+1] - 2f + f[-1])/h_a^2 with the
    framework's boundary semantics on the trailing [nz, ny, nx] axes."""
    per = g.periodic
    out = torch.zeros_like(f)
    for axis, h in ((_SPATIAL[0], g.hz), (_SPATIAL[1], g.hy), (_SPATIAL[2], g.hx)):
        ax = axis % f.ndim
        out = out + (shift(f, +1, ax, per) - 2.0 * f + shift(f, -1, ax, per)) / float(np.float32(h * h))
    return out


@functools.lru_cache(maxsize=32)
def _compact_symbol_np(g: GridSpec) -> np.ndarray:
    def s_of(k, n, h):
        s = np.sin(np.pi * k / n) / h
        return 4.0 * s * s

    kz = np.fft.fftfreq(g.nz) * g.nz
    ky = np.fft.fftfreq(g.ny) * g.ny
    kx = np.fft.rfftfreq(g.nx) * g.nx
    sz = s_of(kz, g.nz, g.hz).astype(np.float32)[:, None, None]
    sy = s_of(ky, g.ny, g.hy).astype(np.float32)[None, :, None]
    sx = s_of(kx, g.nx, g.hx).astype(np.float32)[None, None, :]
    return sz + sy + sx


def _compact_symbol(g: GridSpec, device=None) -> torch.Tensor:
    """-lap(k) = 4 sum_a sin^2(pi k_a/n_a)/h_a^2 >= 0 over the rfftn
    spectrum (x halved): the exact eigenvalues of the periodic compact
    Laplacian, negated."""
    return torch.as_tensor(_compact_symbol_np(g), device=device)


def diffuse_fft(g: GridSpec, f: torch.Tensor, c: float, dt: float) -> torch.Tensor:
    """Exact implicit diffusion step on a periodic grid:
    f_new = F^-1 [ F f / (1 + c dt (-lap(k))) ]."""
    assert g.periodic, "diffuse_fft requires periodic boundaries; use diffuse_cg"
    assert tuple(f.shape[-3:]) == g.shape, (f.shape, g.shape)
    f_hat = torch.fft.rfftn(f, dim=_SPATIAL)
    cdt = float(np.float32(c) * np.float32(dt))
    denom = 1.0 + cdt * _compact_symbol(g, f.device)
    return torch.fft.irfftn(f_hat / denom, s=g.shape, dim=_SPATIAL).to(f.dtype)


def diffuse_cg(
    g: GridSpec, f: torch.Tensor, c: float, dt: float, *, maxiter: int = 100, tol: float = 1e-6
) -> torch.Tensor:
    """Implicit diffusion step under clamp (or periodic) boundaries: CG on
    the SPD system (I - c dt L) f_new = f, warm-started at f."""
    assert tuple(f.shape[-3:]) == g.shape, (f.shape, g.shape)
    cdt = float(np.float32(c) * np.float32(dt))

    def op(x):
        return x - cdt * laplacian(g, x)

    out, _ = cg(op, f, x0=f, tol=tol, maxiter=maxiter)
    return out.to(f.dtype)


def diffuse(
    g: GridSpec, f: torch.Tensor, c: float, dt: float, *, maxiter: int = 100, tol: float = 1e-6
) -> torch.Tensor:
    """Boundary-aware dispatch: FFT on periodic grids, CG on clamp grids;
    the identity when c == 0."""
    if c == 0.0:
        return f
    if g.periodic:
        return diffuse_fft(g, f, c, dt)
    return diffuse_cg(g, f, c, dt, maxiter=maxiter, tol=tol)
