"""K8: the semi-Lagrangian transport step (port of
phys_autodiff_tpu/pallas/transport.py; CUDA source csrc/transport.cu).

The JAX package has three pallas_call sites for one step: a per-plane and a
slab pipeline of the step from sigma and u (K8a, K8b), and a variant from
six precomputed signed weight planes for frozen-velocity rollouts (K8c). On
the card the first two are ONE kernel over C scalars [C, nz, ny, nx] that
share one velocity (C = 1 is apps/transport.transport_step, C = 3 the Euler
solver's velocity self-advection), and the third is the same kernel reading
the weights. Any grid: the TPU tiling gate (transport_kernel_supported) is
not carried over.

In the JAX package the XLA roll+select step is the default and the Pallas
kernel a side arm. In the port every step on a CUDA tensor launches K8: the
same function, one kernel in place of a chain of elementwise launches.

Each wrapper runs the plain PyTorch version (the roll+select form of the
JAX package's apps/transport._axis_lerp) for CPU tensors and launches the kernel for
CUDA tensors. The step from sigma and u is differentiable: an
autograd.Function whose forward is the kernel and whose backward is autograd
through the plain version, recomputed (rollout_loss and
fit_initial_velocity differentiate through it). The weights form is
forward-only, as in JAX.

Rounding: the offset scales are f32(dt) / f32(h) computed on the host, as
the XLA step computes them (the Pallas kernel's dt * f32(1/h) rounds
differently), and the kernel rounds every operation in the plain version's
order, so the two agree bitwise on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.residuals import _staged_vjp
from phys_autodiff_tpu_torch.ops.stencil import shift
from phys_autodiff_tpu_torch.utils.config import GridSpec

#: Most channels one launch of the kernel takes (csrc/transport.cu).
MAX_CHANNELS = 4


def offset_scales(g: GridSpec, dt) -> tuple[np.float32, np.float32, np.float32]:
    """(f32(dt)/f32(hx), f32(dt)/f32(hy), f32(dt)/f32(hz)) in float32: the
    factors that turn a velocity into a departure offset in cells."""
    dt32 = np.float32(dt)
    return tuple(dt32 / np.float32(h) for h in (g.hx, g.hy, g.hz))


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, lo, hi): maximum with lo, then minimum with hi. torch's
    maximum / minimum split a tie's gradient in half, as JAX's do
    (torch.clamp gives it all to x)."""
    return torch.minimum(hi, torch.maximum(lo, x))


def offsets(g: GridSpec, u: torch.Tensor, dt):
    """Per-axis departure offsets in cells, clipped to the one-cell ring:
    (dx, dy, dz), each [nz, ny, nx] float32."""
    lo = torch.full((), -1.0, device=u.device)
    return tuple(_clip(u[a].to(torch.float32) * float(s), lo, -lo) for a, s in enumerate(offset_scales(g, dt)))


def _axis_lerp_many(f: torch.Tensor, d: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """A [C, nz, ny, nx] batch of scalars interpolated at (index - d) along
    `axis` (0 z, 1 y, 2 x of the field), d in [-1, 1] cells shared by the
    channels: for d >= 0 the nodes i-1 and i (weight |d| on i-1), else i
    and i+1. A convex combination (monotone). The weight takes f's type
    (the bf16 tier rounds it to bf16)."""
    f_m = shift(f, -1, axis + 1, periodic)  # value at i-1
    f_p = shift(f, +1, axis + 1, periodic)  # value at i+1
    right = d >= 0
    # |d| as a select, whose derivative at d = 0 is +1 as JAX's abs has it
    # (torch.abs has 0 there, which would stall gradients at zero velocity)
    w = torch.where(right, d, -d).to(f.dtype)[None]
    nbr = torch.where(right[None], f_m, f_p)
    return f + w * (nbr - f)


def _axis_lerp(f: torch.Tensor, d: torch.Tensor, axis: int, periodic: bool) -> torch.Tensor:
    """_axis_lerp_many for one scalar field [nz, ny, nx]."""
    return _axis_lerp_many(f[None], d, axis, periodic)[0]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (what the kernel computes, op for op)
# ---------------------------------------------------------------------------


def transport_step_many_plain(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """[C, nz, ny, nx] fields one semi-Lagrangian step through u: separable
    sweeps x, then y, then z (the roll+select form)."""
    dx, dy, dz = offsets(g, u, dt)
    per = g.periodic
    out = _axis_lerp_many(fields, dx, 2, per)
    out = _axis_lerp_many(out, dy, 1, per)
    return _axis_lerp_many(out, dz, 0, per)


def transport_step_plain(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """transport_step_many_plain for one scalar [nz, ny, nx]."""
    return transport_step_many_plain(g, sigma[None], u, dt)[0]


def transport_weights(g: GridSpec, u: torch.Tensor, dt):
    """The six signed offset-weight planes (xp, xm, yp, ym, zp, zm), each
    [nz, ny, nx]: p = max(d, 0), m = max(-d, 0) per axis. Compute once per
    frozen-velocity rollout (plain PyTorch, as JAX computes it in XLA)."""
    out = []
    for d in offsets(g, u, dt):
        out += [torch.clamp_min(d, 0.0), torch.clamp_min(-d, 0.0)]
    return tuple(out)


def transport_pre_plain(g: GridSpec, sigma: torch.Tensor, weights) -> torch.Tensor:
    """The step from precomputed weights: per axis
    a = s + p * (s[i-1] - s) + m * (s[i+1] - s)."""
    xp, xm, yp, ym, zp, zm = weights
    per = g.periodic
    a = sigma
    for axis, p, m in ((2, xp, xm), (1, yp, ym), (0, zp, zm)):
        a = a + p * (shift(a, -1, axis, per) - a) + m * (shift(a, +1, axis, per) - a)
    return a


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _launch(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One launch of k_transport per MAX_CHANNELS channels."""
    out = torch.empty_like(fields)
    dev = fields.device
    scales = [float(s) for s in offset_scales(g, dt)]
    with torch.cuda.device(dev):
        for c0 in range(0, fields.shape[0], MAX_CHANNELS):
            chunk = fields[c0 : c0 + MAX_CHANNELS]
            err = _build.lib().pat_transport(
                chunk.data_ptr(), u.data_ptr(), out[c0 : c0 + MAX_CHANNELS].data_ptr(), chunk.shape[0],
                g.nx, g.ny, g.nz, int(g.periodic), *scales, _build.stream_ptr(dev),
            )
            _build.check(err, "transport kernel")
            _build.LAUNCHES["transport"] += 1
    return out


class _Transport(torch.autograd.Function):
    """[C, nz, ny, nx] fields one step through u [3, nz, ny, nx]."""

    @staticmethod
    def forward(ctx, g, dt, fields, u):
        ctx.g, ctx.dt = g, dt
        ctx.save_for_backward(fields, u)
        if not _build.uses_kernel(fields, u):
            return transport_step_many_plain(g, fields, u, dt)
        return _launch(g, fields, u, dt)

    @staticmethod
    def backward(ctx, d_out):
        grads = _staged_vjp(lambda f, v: transport_step_many_plain(ctx.g, f, v, ctx.dt), ctx.saved_tensors,
                            (d_out,))
        return (None, None, *grads)


def transport_step_many_fused(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One semi-Lagrangian step of a [C, nz, ny, nx] batch of scalars through
    one velocity field u [3, nz, ny, nx] (dt a Python number); K8 on the
    card, bitwise equal per channel to transport_step_fused. The output is a
    new tensor, so the fields may be u itself. Differentiable."""
    _build.check_shape(u, (3,) + g.shape, "u")
    _build.check_shape(fields, (fields.shape[0],) + g.shape, "fields")
    return _Transport.apply(g, dt, fields.contiguous(), u.contiguous())


def transport_step_fused(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One semi-Lagrangian step of sigma [nz, ny, nx] through u; K8 (C = 1)."""
    return transport_step_many_fused(g, sigma[None], u, dt)[0]


def transport_step_fused_pre(g: GridSpec, sigma: torch.Tensor, weights) -> torch.Tensor:
    """One step of sigma from precomputed transport_weights (frozen-u
    rollouts); K8c on the card. Forward only."""
    weights = tuple(w.contiguous() for w in weights)
    sigma = sigma.contiguous()
    if not _build.uses_kernel(sigma, *weights):
        return transport_pre_plain(g, sigma, weights)
    for i, w in enumerate(weights):
        _build.check_shape(w, g.shape, f"weights[{i}]")
    _build.check_shape(sigma, g.shape, "sigma")
    out = torch.empty_like(sigma)
    dev = sigma.device
    with torch.cuda.device(dev):
        err = _build.lib().pat_transport_pre(
            sigma.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(), g.nx, g.ny, g.nz,
            int(g.periodic), _build.stream_ptr(dev),
        )
    _build.check(err, "transport_pre kernel")
    _build.LAUNCHES["transport_pre"] += 1
    return out
