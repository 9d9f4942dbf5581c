"""Float64 NumPy oracle for the transport-equation residual/loss operator
(the port's own copy of phys_autodiff_tpu/ref/oracle.py).

This is the framework's ground-truth arm, playing the role of the reference's
CPU implementation (src/phys_cpu.cpp): all intermediate arithmetic is done in
float64 on float32 inputs, and results are cast back to float32. It is pure
NumPy (vectorized, no scalar loops) and never runs on the device.

Semantics replicated exactly (with citations):

  * Central differences in time: (f_tp1 - f_tm1) / (2 dt)
    (src/phys_cpu.cpp:71-77) and space: (f[i+1] - f[i-1]) / (2 h)
    (src/phys_cpu.cpp:80-93).
  * Boundary handling: periodic wrap, or index clamp — clamp turns the edge
    "central" difference into (f[1] - f[0]) / (2 h) (src/phys_cpu.cpp:8-15,
    43-52).
  * Residuals (src/phys_cpu.cpp:96-106, REQUIREMENT.md:18-26):
        R_sigma = dsigma/dt + u . grad(sigma) + sigma * div(u)
        R_u     = du/dt + (u . grad) u
  * Loss (src/phys_cpu.cpp:140-148): L_s = w_sigma * sum(R_sigma^2) / N,
    L_u = w_u * sum(R_ux^2 + R_uy^2 + R_uz^2) / N  (mean over N, not 3N),
    accumulated in float64.
  * Backward w.r.t. residuals (src/phys_cpu.cpp:151-170, include/phys.h:54):
    g = (2 w / N) * R, with the scale computed in float32 as
    2*w/float(N) to match the reference bit-for-bit.

Array layout: scalar fields [nz, ny, nx], vector fields [3, nz, ny, nx].
"""

from __future__ import annotations

import numpy as np

from phys_autodiff_tpu_torch.utils.config import GridSpec, PhysWeights


def _shift(f: np.ndarray, delta: int, axis: int, periodic: bool) -> np.ndarray:
    """f evaluated at index i+delta along `axis` with wrap or clamp boundary.

    np.roll(f, -delta) puts f[i+delta] at position i (wrap). For clamp,
    out-of-range neighbors are replaced with the edge plane, matching the
    reference's clampi (src/phys_cpu.cpp:8-10).
    """
    if periodic:
        return np.roll(f, -delta, axis=axis)
    shifted = np.roll(f, -delta, axis=axis)
    idx = [slice(None)] * f.ndim
    if delta > 0:
        # positions n-delta..n-1 clamp to the last plane
        idx[axis] = slice(f.shape[axis] - delta, None)
        edge = [slice(None)] * f.ndim
        edge[axis] = slice(f.shape[axis] - 1, f.shape[axis])
        shifted[tuple(idx)] = f[tuple(edge)]
    elif delta < 0:
        idx[axis] = slice(0, -delta)
        edge = [slice(None)] * f.ndim
        edge[axis] = slice(0, 1)
        shifted[tuple(idx)] = f[tuple(edge)]
    return shifted


def _central(f: np.ndarray, axis: int, inv2h: float, periodic: bool) -> np.ndarray:
    return (_shift(f, +1, axis, periodic) - _shift(f, -1, axis, periodic)) * inv2h


def _upwind(
    f: np.ndarray, a: np.ndarray, axis: int, invh: float, periodic: bool
) -> np.ndarray:
    """First-order upwind derivative of f along `axis`, advected by velocity
    a: backward difference where a > 0, forward difference otherwise
    (REQUIREMENT.md:131-134, the M4 advection switch)."""
    bwd = (f - _shift(f, -1, axis, periodic)) * invh
    fwd = (_shift(f, +1, axis, periodic) - f) * invh
    return np.where(a > 0.0, bwd, fwd)


# Axis indices of a [nz, ny, nx] array.
_AXIS_Z, _AXIS_Y, _AXIS_X = 0, 1, 2


def residuals(
    g: GridSpec,
    sigma_tm1: np.ndarray,
    sigma_t: np.ndarray,
    sigma_tp1: np.ndarray,
    u_tm1: np.ndarray,
    u_t: np.ndarray,
    u_tp1: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Transport residuals in f64 internals; returns (R_sigma [nz,ny,nx],
    R_u [3,nz,ny,nx]) as float32."""
    s_tm1 = np.asarray(sigma_tm1, dtype=np.float64).reshape(g.shape)
    s_t = np.asarray(sigma_t, dtype=np.float64).reshape(g.shape)
    s_tp1 = np.asarray(sigma_tp1, dtype=np.float64).reshape(g.shape)
    v_tm1 = np.asarray(u_tm1, dtype=np.float64).reshape((3,) + g.shape)
    v_t = np.asarray(u_t, dtype=np.float64).reshape((3,) + g.shape)
    v_tp1 = np.asarray(u_tp1, dtype=np.float64).reshape((3,) + g.shape)

    # Inverse step factors computed in double from the float32 spec values,
    # matching src/phys_cpu.cpp:38-41.
    inv2dt = 1.0 / (2.0 * np.float64(np.float32(g.dt)))
    inv2hx = 1.0 / (2.0 * np.float64(np.float32(g.hx)))
    inv2hy = 1.0 / (2.0 * np.float64(np.float32(g.hy)))
    inv2hz = 1.0 / (2.0 * np.float64(np.float32(g.hz)))
    per = g.periodic

    # Time derivatives (central)
    dt_sigma = (s_tp1 - s_tm1) * inv2dt
    du_dt = (v_tp1 - v_tm1) * inv2dt

    # Spatial gradients of sigma_t
    ds_dx = _central(s_t, _AXIS_X, inv2hx, per)
    ds_dy = _central(s_t, _AXIS_Y, inv2hy, per)
    ds_dz = _central(s_t, _AXIS_Z, inv2hz, per)

    # Full velocity gradient tensor d u_c / d axis, u channel order (x, y, z)
    ux, uy, uz = v_t[0], v_t[1], v_t[2]
    dux_dx = _central(ux, _AXIS_X, inv2hx, per)
    dux_dy = _central(ux, _AXIS_Y, inv2hy, per)
    dux_dz = _central(ux, _AXIS_Z, inv2hz, per)
    duy_dx = _central(uy, _AXIS_X, inv2hx, per)
    duy_dy = _central(uy, _AXIS_Y, inv2hy, per)
    duy_dz = _central(uy, _AXIS_Z, inv2hz, per)
    duz_dx = _central(uz, _AXIS_X, inv2hx, per)
    duz_dy = _central(uz, _AXIS_Y, inv2hy, per)
    duz_dz = _central(uz, _AXIS_Z, inv2hz, per)

    div_u = dux_dx + duy_dy + duz_dz  # divergence stays central in both schemes

    if g.scheme == "upwind":
        invhx, invhy, invhz = 2.0 * inv2hx, 2.0 * inv2hy, 2.0 * inv2hz
        up = lambda f, a, ax, ih: _upwind(f, a, ax, ih, per)
        adv_sigma = (
            ux * up(s_t, ux, _AXIS_X, invhx)
            + uy * up(s_t, uy, _AXIS_Y, invhy)
            + uz * up(s_t, uz, _AXIS_Z, invhz)
        )
        adv = lambda f: (
            ux * up(f, ux, _AXIS_X, invhx)
            + uy * up(f, uy, _AXIS_Y, invhy)
            + uz * up(f, uz, _AXIS_Z, invhz)
        )
        adv_ux, adv_uy, adv_uz = adv(ux), adv(uy), adv(uz)
    else:
        adv_sigma = ux * ds_dx + uy * ds_dy + uz * ds_dz
        adv_ux = ux * dux_dx + uy * dux_dy + uz * dux_dz
        adv_uy = ux * duy_dx + uy * duy_dy + uz * duy_dz
        adv_uz = ux * duz_dx + uy * duz_dy + uz * duz_dz

    r_sigma = (dt_sigma + adv_sigma + s_t * div_u).astype(np.float32)
    r_u = np.stack(
        [du_dt[0] + adv_ux, du_dt[1] + adv_uy, du_dt[2] + adv_uz]
    ).astype(np.float32)
    return r_sigma, r_u


def loss_forward(
    g: GridSpec,
    w: PhysWeights,
    sigma_tm1,
    sigma_t,
    sigma_tp1,
    u_tm1,
    u_t,
    u_tp1,
    return_residuals: bool = False,
):
    """Weighted MSE losses with float64 accumulation (src/phys_cpu.cpp:140-148).

    Returns (loss_sigma, loss_u) as float32, optionally with the residuals.
    """
    r_sigma, r_u = residuals(g, sigma_tm1, sigma_t, sigma_tp1, u_tm1, u_t, u_tp1)
    n = float(g.num_cells)
    acc_sigma = np.sum(np.asarray(r_sigma, dtype=np.float64) ** 2)
    acc_u = np.sum(np.asarray(r_u, dtype=np.float64) ** 2)
    loss_sigma = np.float32(w.w_sigma * acc_sigma / n)
    loss_u = np.float32(w.w_u * acc_u / n)
    if return_residuals:
        return loss_sigma, loss_u, r_sigma, r_u
    return loss_sigma, loss_u


def loss_backward(
    g: GridSpec, w: PhysWeights, r_sigma, r_u
) -> tuple[np.ndarray, np.ndarray]:
    """Residual-space VJP: g = (2 w / N) * R (src/phys_cpu.cpp:161-169).

    The scales are computed in float32 exactly like the reference
    (2.f * w / float(N)).
    """
    n = np.float32(g.num_cells)
    scale_sigma = np.float32(2.0) * np.float32(w.w_sigma) / n
    scale_u = np.float32(2.0) * np.float32(w.w_u) / n
    g_sigma = (scale_sigma * np.asarray(r_sigma, dtype=np.float32)).astype(np.float32)
    g_u = (scale_u * np.asarray(r_u, dtype=np.float32)).astype(np.float32)
    return g_sigma, g_u
