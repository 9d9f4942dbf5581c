"""K8: the semi-Lagrangian transport step (port of
phys_autodiff_tpu/pallas/transport.py; CUDA source csrc/transport.cu).

The JAX package has three pallas_call sites for one step: a per-plane and a
slab pipeline of the step from sigma and u (K8a, K8b), and a variant from
six precomputed signed weight planes for frozen-velocity rollouts (K8c). On
the card the first two are ONE kernel over C scalars [C, nz, ny, nx] that
share one velocity (C = 1 is apps/transport.transport_step, C = 3 the Euler
solver's velocity self-advection), and the third is the same kernel reading
the weights. Any grid: the TPU tiling gate (transport_kernel_supported) is
not carried over. The host sizes the kernel's grid (launch_geometry: z
chunks that fill the card in balanced waves) and passes the chunk along.

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

The slab form (transport_step_slab: K8 on a halo-extended slab, the
z-sharded step of apps/transport.py) takes a rank's nz_local planes with one
halo plane a side, [C, nz_local + 2, ny, nx] and u [3, nz_local + 2, ny, nx],
and writes only the nz_local owned planes. The halo planes are real planes
of the neighbouring ranks (or, at a clamped grid's edge, the edge plane
itself), so the z sweep reads them as they are; each owned plane is bitwise
the whole-grid step's. The input is a torch.cat-extended slab (the
exchange, parallel/sharded.halo_extend_z_diff, returns one): one copy of the
slab a step, and the kernel keeps the whole-grid walk, its row tables and
its 16-byte copies, which pointers to two separate halo planes would split.

Rounding: the offset scales are f32(dt) / f32(h) computed on the host, as
the XLA step computes them (the Pallas kernel's dt * f32(1/h) rounds
differently), and the kernel rounds every operation in the plain version's
order, so the two agree bitwise on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.residuals import _staged_vjp
from phys_autodiff_tpu_torch.ops.stencil import shift
from phys_autodiff_tpu_torch.utils import checks
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


def transport_step_slab_plain(g: GridSpec, fields_ext: torch.Tensor, u_ext: torch.Tensor, dt) -> torch.Tensor:
    """The slab form's plain version: the plain step on the slab's own grid
    of nz_local + 2 planes (g's spacing and boundary), its owned planes
    [1:-1]. Their z sweep reads only the slab's planes, so the grid's z
    rule never fires for them."""
    g_ext = dataclasses.replace(g, nz=fields_ext.shape[1])
    return transport_step_many_plain(g_ext, fields_ext, u_ext, dt)[:, 1:-1]


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

#: The (x, y) tile of one block of k_transport (csrc/transport.cu TX, TY).
TILE_X, TILE_Y = 32, 8
#: A wave of the grid: the H100's SMs times the blocks of k_transport that
#: one SM holds (its __launch_bounds__, csrc/transport.cu BLOCKS_PER_SM).
NUM_SMS, BLOCKS_PER_SM = 132, 4
#: The planes' worth of time a block spends before its first plane lands
#: (the ring's first load round), in the cost of a z chunk.
FILL_PLANES = 2


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_geometry(nx: int, ny: int, nz: int) -> tuple[int, int]:
    """(zc, blocks): the z chunk each block of k_transport walks and the
    grid's block count, tiles x z chunks. zc is the one that minimises
    waves x (zc + 2 halo planes + FILL_PLANES), a wave being NUM_SMS *
    BLOCKS_PER_SM blocks: at 128x96x96 zc = 9 (528 blocks, one wave), at
    256^3 zc = 128 (512 blocks, one wave, the whole z walk streamed)."""
    ntiles = _ceil_div(nx, TILE_X) * _ceil_div(ny, TILE_Y)
    wave = NUM_SMS * BLOCKS_PER_SM
    best = None
    for zc in range(1, nz + 1):
        blocks = ntiles * _ceil_div(nz, zc)
        cost = _ceil_div(blocks, wave) * (zc + 2 + FILL_PLANES)
        if best is None or cost < best[0]:
            best = (cost, zc, blocks)
    return best[1], best[2]


def block_walks(g: GridSpec) -> list[tuple[int, int, int, int]]:
    """(x0, y0, z0, z1) of each block in block order, as csrc/transport.cu
    walk_of decodes blockIdx: tile fastest (x tiles, then y tiles), then the
    z chunk. The block writes cells [x0, x0 + TILE_X) x [y0, y0 + TILE_Y) x
    [z0, z1) that lie in the grid and reads planes z0 - 1 .. z1, rows
    y0 - 1 .. y0 + TILE_Y and columns x0 - 1 .. x0 + TILE_X, each mapped
    into the grid by the boundary (ops/stencil.shift's wrap or clamp)."""
    zc, blocks = launch_geometry(g.nx, g.ny, g.nz)
    ntx = _ceil_div(g.nx, TILE_X)
    ntiles = ntx * _ceil_div(g.ny, TILE_Y)
    out = []
    for b in range(blocks):
        tile, z0 = b % ntiles, b // ntiles * zc
        out.append((tile % ntx * TILE_X, tile // ntx * TILE_Y, z0, min(z0 + zc, g.nz)))
    return out


@functools.lru_cache(maxsize=256)
def _launch_args(g: GridSpec, dt, nz_out: int) -> tuple[int, float, float, float]:
    """(zc, sx, sy, sz): the launch geometry's z chunk over nz_out output
    planes and offset_scales as Python floats (the same float32 values),
    once per grid, dt and plane count."""
    return (launch_geometry(g.nx, g.ny, nz_out)[0], *(float(s) for s in offset_scales(g, dt)))


#: The plain version of each form: the whole grid (slab=False) or the slab.
_PLAIN = {False: transport_step_many_plain, True: transport_step_slab_plain}


def _launch(g: GridSpec, dt, slab: bool, fields: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One launch of k_transport per MAX_CHANNELS channels: pat_transport on
    the whole grid, or pat_transport_slab on a slab of nz_local + 2 planes,
    its nz_local owned planes out."""
    c_all, nz_in = fields.shape[0], fields.shape[1]
    nz_out = nz_in - 2 if slab else nz_in
    out = fields.new_empty((c_all, nz_out, g.ny, g.nx))
    zc, sx, sy, sz = _launch_args(g, dt, nz_out)
    dev, lib = fields.device, _build.lib()
    entry, name = (lib.pat_transport_slab, "transport slab") if slab else (lib.pat_transport, "transport")
    n_in, n_out = 4 * g.ny * g.nx * nz_in, 4 * g.ny * g.nx * nz_out
    f_ptr, u_ptr, o_ptr = fields.data_ptr(), u.data_ptr(), out.data_ptr()
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        for c0 in range(0, c_all, MAX_CHANNELS):
            err = entry(f_ptr + c0 * n_in, u_ptr, o_ptr + c0 * n_out, min(MAX_CHANNELS, c_all - c0), g.nx, g.ny,
                        nz_out, int(g.periodic), zc, sx, sy, sz, stream)
            _build.check(err, f"{name} kernel")
            _build.LAUNCHES[name] += 1
    if checks.active:
        checks.record_kernel("K8", (out,))
    return out


def _step(g: GridSpec, dt, slab: bool, fields: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The step's forward: the plain version for CPU tensors, else K8."""
    if not _build.uses_kernel(fields, u):
        return _PLAIN[slab](g, fields, u, dt)
    return _launch(g, dt, slab, fields, u)


class _Transport(torch.autograd.Function):
    """[C, nz, ny, nx] fields one step through u [3, nz, ny, nx] (or, slab,
    the owned planes of a halo-extended slab); the backward is autograd
    through the plain version, recomputed."""

    @staticmethod
    def forward(ctx, g, dt, slab, fields, u):
        ctx.g, ctx.dt, ctx.slab = g, dt, slab
        ctx.save_for_backward(fields, u)
        return _step(g, dt, slab, fields, u)

    @staticmethod
    def backward(ctx, d_out):
        plain = _PLAIN[ctx.slab]
        grads = _staged_vjp(lambda f, v: plain(ctx.g, f, v, ctx.dt), ctx.saved_tensors, (d_out,))
        return (None, None, None, *grads)


def _apply(g: GridSpec, dt, slab: bool, fields: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The step, through the autograd.Function only where a gradient is
    asked for."""
    fields, u = fields.contiguous(), u.contiguous()
    if torch.is_grad_enabled() and (fields.requires_grad or u.requires_grad):
        return _Transport.apply(g, dt, slab, fields, u)
    return _step(g, dt, slab, fields, u)


def transport_step_many_fused(g: GridSpec, fields: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One semi-Lagrangian step of a [C, nz, ny, nx] batch of scalars through
    one velocity field u [3, nz, ny, nx] (dt a Python number); K8 on the
    card, bitwise equal per channel to transport_step_fused. The output is a
    new tensor, so the fields may be u itself. Differentiable."""
    _build.check_shape(u, (3,) + g.shape, "u")
    _build.check_shape(fields, (fields.shape[0],) + g.shape, "fields")
    return _apply(g, dt, False, fields, u)


def transport_step_fused(g: GridSpec, sigma: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One semi-Lagrangian step of sigma [nz, ny, nx] through u; K8 (C = 1)."""
    return transport_step_many_fused(g, sigma[None], u, dt)[0]


def transport_step_slab(g: GridSpec, fields_ext: torch.Tensor, u_ext: torch.Tensor, dt) -> torch.Tensor:
    """K8's slab form: a [C, nz_local + 2, ny, nx] batch of scalars (a rank's
    planes and one halo plane a side) one semi-Lagrangian step through u_ext
    [3, nz_local + 2, ny, nx]; returns the owned planes [C, nz_local, ny, nx],
    bitwise the whole-grid step's rows. g is the global grid (spacing and
    boundary); the planes come from the tensors. fields_ext may be u_ext
    itself (the self-advection). Differentiable in both inputs."""
    c, nze = fields_ext.shape[0], fields_ext.shape[1]
    if nze < 3:
        raise ValueError(f"a slab holds nz_local + 2 >= 3 planes, got {nze}")
    _build.check_shape(fields_ext, (c, nze, g.ny, g.nx), "fields_ext")
    _build.check_shape(u_ext, (3, nze, g.ny, g.nx), "u_ext")
    return _apply(g, dt, True, fields_ext, u_ext)


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
    zc = launch_geometry(g.nx, g.ny, g.nz)[0]
    dev = sigma.device
    with torch.cuda.device(dev):
        err = _build.lib().pat_transport_pre(
            sigma.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(), g.nx, g.ny, g.nz,
            int(g.periodic), zc, _build.stream_ptr(dev),
        )
    _build.check(err, "transport_pre kernel", "K8c", (out,))
    _build.LAUNCHES["transport_pre"] += 1
    return out
