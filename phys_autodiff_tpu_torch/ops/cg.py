"""Conjugate gradients for the fluid ops' implicit solves (the port of
jax.scipy.sparse.linalg.cg as the JAX package's ops/projection.py,
ops/diffusion.py and ops/obstacles.py call it).

The iteration, its stopping rule and its gradient are JAX's:

  * x0 defaults to zeros; r0 = b - A x0, p0 = r0, gamma0 = r0.r0;
    iterate while gamma > max(tol^2 (b.b), 0) and k < maxiter;
  * the result is differentiable in b by implicit differentiation, not by
    unrolling: the cotangent of b is cg(A^T, x_bar) with the same x0, tol
    and maxiter (A is symmetric in every caller: the normal equations of
    CGNR, the SPD diffusion resolvent), so nothing of the iterations is
    kept for the backward.

The stopping rule is read on the device. A Python loop that asked the
host for gamma every iteration would wait for the device up to maxiter
times a solve. Instead each iteration freezes x, r, gamma and p with
torch.where once the rule has fired (the frozen state is the state at
which JAX's while_loop stops), and the host reads the rule only every
CHECK_EVERY iterations to leave the loop early: at most
maxiter / CHECK_EVERY waits a solve, and at most CHECK_EVERY - 1
iterations of frozen work after convergence.
"""

from __future__ import annotations

import numpy as np
import torch

#: Iterations between two host reads of the stopping rule.
CHECK_EVERY = 8


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _solve(A, b: torch.Tensor, x0, tol: float, maxiter: int, vdot=_vdot):
    """(x, iterations) of CG on A x = b; no autograd. vdot(x, y) is the
    inner product (a rank's rows' dot product all-reduced on a mesh)."""
    with torch.no_grad():
        x = torch.zeros_like(b) if x0 is None else x0.detach().clone()
        tol32 = np.float32(tol)
        atol2 = torch.clamp_min(float(tol32 * tol32) * vdot(b, b), 0.0)
        r = b - A(x)
        p = r
        gamma = vdot(r, r)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        for it in range(maxiter):
            active = gamma > atol2
            if it and it % CHECK_EVERY == 0 and not bool(active):
                break
            Ap = A(p)
            alpha = gamma / vdot(p, Ap)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            gamma_new = vdot(r_new, r_new)
            p_new = r_new + (gamma_new / gamma) * p
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            gamma = torch.where(active, gamma_new, gamma)
            k = k + active.to(torch.int64)
        return x, k


class _CG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, b, x0, tol, maxiter, vdot):
        ctx.A, ctx.x0, ctx.tol, ctx.maxiter, ctx.vdot = A, x0, tol, maxiter, vdot
        x, k = _solve(A, b, x0, tol, maxiter, vdot)
        ctx.mark_non_differentiable(k)
        return x, k

    @staticmethod
    def backward(ctx, x_bar, _k_bar):
        b_bar, _ = _solve(ctx.A, x_bar.contiguous(), ctx.x0, ctx.tol, ctx.maxiter, ctx.vdot)
        return None, b_bar, None, None, None, None


def cg(A, b: torch.Tensor, x0: torch.Tensor | None = None, *, tol: float = 1e-5, maxiter: int, vdot=_vdot):
    """Solve A x = b for a symmetric positive (semi-)definite linear operator
    A (a function of one tensor shaped like b). Returns (x, iterations): the
    iteration count is a 0-dim int64 tensor on b's device (JAX returns None
    in that slot). x is differentiable in b; x0 is a starting point only.
    vdot(x, y) -> a 0-dim tensor is the inner product: the default is the
    dot product of the whole tensors; a sharded solve passes one that
    all-reduces its rows' dot product, the same bits on every rank, so
    that every rank stops at the same iteration."""
    x0 = None if x0 is None else x0.detach()
    return _CG.apply(A, b, x0, tol, maxiter, vdot)
