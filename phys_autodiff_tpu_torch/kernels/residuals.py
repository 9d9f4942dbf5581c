"""K1: the fused transport-residual kernel (port of
phys_autodiff_tpu/pallas/residuals.py; CUDA source csrc/residuals.cu).

The JAX package has three pallas_call sites for one computation on three TPU
layouts (separate arrays with manual DMA, per-plane, packed). On the card
they are ONE kernel that takes any grid and reads the 12 field channels
through 12 base pointers, so the six-array entry points (FieldSnapshots)
and the packed entry points ([12, nz, ny, nx] in PACKED_ORDER) share it
without a pack copy. Epilogues: the residuals, the scaled backward
g = (2w/N) R, or per-plane loss partials added in a fixed order (no
atomics) into (L_sigma, L_u).

Each entry point runs the plain PyTorch version (the staged ops of
ops/stencil.py and ops/loss.py) for CPU tensors and launches the kernel
for CUDA tensors. The residual and loss-forward entry points are
differentiable: an autograd.Function whose forward is the kernel (or, for
CPU tensors, the plain version) and whose backward is the staged arm's
autograd, as the JAX custom_vjps (pallas/residuals.py:645-669, :1120-1130,
:1462-1478). The scaled backward (loss_backward_fused*) is itself a
backward and has none: CUDA inputs that require grad raise there.

The bf16-I/O tiers are entry points of their own, as in the JAX package
(pallas/residuals.py:1037-1103): residuals_fused_packed_bf16 (bf16 fields
in, bf16 residuals out) and residuals_fused_packed_mixed_out (float32 in,
bf16 out), both with float32 arithmetic inside, on the same kernel body
instantiated for those element types. The f32 wrappers given "bf16" raise
ValueError naming them.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

#: Channel order of the packed field array.
PACKED_ORDER = (
    "sigma_tm1", "sigma_t", "sigma_tp1",
    "ux_tm1", "uy_tm1", "uz_tm1",
    "ux_t", "uy_t", "uz_t",
    "ux_tp1", "uy_tp1", "uz_tp1",
)

MODE_RESIDUALS, MODE_SCALED, MODE_PARTIALS = 0, 1, 2
# The kernels' (x, y) tile (csrc/stencil.cuh TILE_X, TILE_Y): one loss
# partial per tile and z plane.
TILE_X, TILE_Y = 32, 8


def pack_fields(fields: FieldSnapshots) -> torch.Tensor:
    """FieldSnapshots -> packed [12, nz, ny, nx] (PACKED_ORDER)."""
    return torch.cat(
        [
            fields.sigma_tm1[None],
            fields.sigma_t[None],
            fields.sigma_tp1[None],
            fields.u_tm1,
            fields.u_t,
            fields.u_tp1,
        ],
        dim=0,
    )


def unpack_fields(packed: torch.Tensor) -> FieldSnapshots:
    return FieldSnapshots(
        sigma_tm1=packed[0],
        sigma_t=packed[1],
        sigma_tp1=packed[2],
        u_tm1=packed[3:6],
        u_t=packed[6:9],
        u_tp1=packed[9:12],
    )


def _channels(fields: FieldSnapshots) -> list[torch.Tensor]:
    """The 12 channel planes of FieldSnapshots in PACKED_ORDER (views)."""
    return [
        fields.sigma_tm1, fields.sigma_t, fields.sigma_tp1,
        *fields.u_tm1, *fields.u_t, *fields.u_tp1,
    ]


def _uses_kernel(g: GridSpec, fields: FieldSnapshots, precision: str) -> bool:
    _build.check_precision(precision, "K1")
    tensors = list(fields)
    if not _build.uses_kernel(*tensors):
        return False
    for name, t in zip(FieldSnapshots._fields, tensors):
        shape = g.shape if name.startswith("sigma") else (3,) + g.shape
        _build.check_shape(t, shape, name)
    return True


def _uses_kernel_packed(g: GridSpec, packed: torch.Tensor, precision: str) -> bool:
    _build.check_precision(precision, "K1")
    if not _build.uses_kernel(packed):
        return False
    _build.check_shape(packed, (12,) + g.shape, "packed")
    return True


def num_tiles(g: GridSpec) -> int:
    return -(-g.nx // TILE_X) * (-(-g.ny // TILE_Y))


def _stencil_consts(g: GridSpec) -> list[float]:
    return [float(ops_stencil.inv2h_f32(h)) for h in (g.dt, g.hx, g.hy, g.hz)]


def _launch(g: GridSpec, chans, mode: int, outs=None, tile_parts=None, scales=(0.0, 0.0)):
    """One launch of the residual kernel on the inputs' device."""
    dev = chans[0].device
    out_ptrs = [o.data_ptr() for o in outs] if outs is not None else [None] * 4
    with torch.cuda.device(dev):
        err = _build.lib().pat_residuals(
            *[c.data_ptr() for c in chans],
            *out_ptrs,
            tile_parts.data_ptr() if tile_parts is not None else None,
            g.nx, g.ny, g.nz, int(g.periodic), int(g.scheme == "upwind"), mode,
            *_stencil_consts(g),
            *[float(s) for s in scales],
            _build.stream_ptr(dev),
        )
    _build.check(err, "residuals kernel")
    _build.LAUNCHES["residuals"] += 1


def finalize_partials(g: GridSpec, w: PhysWeights, tile_parts: torch.Tensor):
    """Fixed-order reduction of per-(plane, tile) partials [2, nz, ntiles]
    into the plane partials [2, nz] and the loss [2] = (L_sigma, L_u)
    (the order of ops.loss.sum_partials). Shared by K1 and K3."""
    dev = tile_parts.device
    parts = torch.empty((2, g.nz), dtype=torch.float32, device=dev)
    loss = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().pat_partials_finalize(
            tile_parts.data_ptr(), tile_parts.shape[2], g.nz, parts.data_ptr(),
            loss.data_ptr(), float(np.float32(w.w_sigma)), float(np.float32(w.w_u)),
            float(ops_loss.inv_n_f32(g)), _build.stream_ptr(dev),
        )
    _build.check(err, "partials finalize")
    return parts, loss


def _loss_partials(g: GridSpec, w: PhysWeights, chans):
    tile_parts = torch.empty((2, g.nz, num_tiles(g)), dtype=torch.float32, device=chans[0].device)
    _launch(g, chans, MODE_PARTIALS, tile_parts=tile_parts)
    return finalize_partials(g, w, tile_parts)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (what the kernel computes, op for op)
# ---------------------------------------------------------------------------


def residuals_plain(g: GridSpec, fields: FieldSnapshots):
    return ops_stencil.residuals(g, fields)


def loss_backward_plain(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    return ops_loss.loss_backward(g, w, *ops_stencil.residuals(g, fields))


def loss_partials_plain(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """(plane partials [2, nz], loss [2]) with the fixed-order reduction."""
    parts = ops_loss.plane_partials(*ops_stencil.residuals(g, fields))
    return parts, torch.stack(ops_loss.sum_partials(g, w, parts))


# ---------------------------------------------------------------------------
# Autograd: kernel forward, staged backward
# ---------------------------------------------------------------------------


def _staged_vjp(fn, inputs, cotangents):
    """Gradients of fn(*inputs) w.r.t. inputs for the given output
    cotangents, by autograd through the staged ops."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        outs = fn(*xs)
    return torch.autograd.grad(outs, xs, cotangents, allow_unused=True)


class _Residuals(torch.autograd.Function):
    """(R_sigma, R_u) of six field tensors (FieldSnapshots order)."""

    @staticmethod
    def forward(ctx, g, precision, *fields):
        ctx.g = g
        ctx.save_for_backward(*fields)
        fs = FieldSnapshots(*fields)
        if not _uses_kernel(g, fs, precision):
            return residuals_plain(g, fs)
        dev = fs.sigma_t.device
        rs = torch.empty(g.shape, dtype=torch.float32, device=dev)
        ru = torch.empty((3,) + g.shape, dtype=torch.float32, device=dev)
        _launch(g, _channels(fs), MODE_RESIDUALS, [rs, *ru])
        return rs, ru

    @staticmethod
    def backward(ctx, d_rs, d_ru):
        grads = _staged_vjp(
            lambda *f: residuals_plain(ctx.g, FieldSnapshots(*f)), ctx.saved_tensors, (d_rs, d_ru)
        )
        return (None, None, *grads)


class _ResidualsPacked(torch.autograd.Function):
    """[4, nz, ny, nx] residuals of the packed fields."""

    @staticmethod
    def forward(ctx, g, precision, packed):
        ctx.g = g
        ctx.save_for_backward(packed)
        if not _uses_kernel_packed(g, packed, precision):
            return _residuals_packed_plain(g, packed)
        out = torch.empty((4,) + g.shape, dtype=torch.float32, device=packed.device)
        _launch(g, list(packed), MODE_RESIDUALS, list(out))
        return out

    @staticmethod
    def backward(ctx, d_out):
        (d_packed,) = _staged_vjp(
            lambda p: _residuals_packed_plain(ctx.g, p), ctx.saved_tensors, (d_out,)
        )
        return None, None, d_packed


class _LossForward(torch.autograd.Function):
    """(L_sigma, L_u) as a [2] tensor, from six field tensors."""

    @staticmethod
    def forward(ctx, g, w, precision, *fields):
        ctx.g, ctx.w = g, w
        ctx.save_for_backward(*fields)
        fs = FieldSnapshots(*fields)
        if not _uses_kernel(g, fs, precision):
            return loss_partials_plain(g, w, fs)[1]
        return _loss_partials(g, w, _channels(fs))[1]

    @staticmethod
    def backward(ctx, d_loss):
        grads = _staged_vjp(
            lambda *f: _loss_terms_plain(ctx.g, ctx.w, FieldSnapshots(*f)), ctx.saved_tensors, (d_loss,)
        )
        return (None, None, None, *grads)


class _ResidualsPackedLowOut(torch.autograd.Function):
    """bf16 [4, nz, ny, nx] residuals of the packed fields, bf16 (in_kind
    "bf16") or float32 ("mixed_out"), with float32 arithmetic. The backward
    is JAX's (pallas/residuals.py:1057-1073, :1091-1103): the float32 staged
    adjoint on the upcast input, fed the upcast cotangent (the output cast
    is straight-through), its result cast to the input's type."""

    @staticmethod
    def forward(ctx, g, in_kind, packed):
        ctx.g = g
        ctx.save_for_backward(packed)
        want = torch.bfloat16 if in_kind == "bf16" else torch.float32
        if packed.dtype != want:
            raise TypeError(f"residuals_fused_packed_{in_kind}: fields must be {want}, got {packed.dtype}")
        dev = packed.device
        if dev.type == "cpu":
            return residuals_low_out_plain(g, packed)
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        if not packed.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        _build.check_shape(packed, (12,) + g.shape, "packed")
        out = torch.empty((4,) + g.shape, dtype=torch.bfloat16, device=dev)
        name = "pat_residuals_bf16" if in_kind == "bf16" else "pat_residuals_mixed_out"
        with torch.cuda.device(dev):
            err = getattr(_build.lib(), name)(
                *[c.data_ptr() for c in packed], *[o.data_ptr() for o in out],
                g.nx, g.ny, g.nz, int(g.periodic), int(g.scheme == "upwind"), *_stencil_consts(g),
                _build.stream_ptr(dev),
            )
        _build.check(err, f"residuals kernel ({in_kind})")
        _build.LAUNCHES["residuals bf16" if in_kind == "bf16" else "residuals mixed_out"] += 1
        return out

    @staticmethod
    def backward(ctx, d_out):
        (packed,) = ctx.saved_tensors
        (d_packed,) = _staged_vjp(
            lambda p: _residuals_packed_plain(ctx.g, p), [packed.float()], (d_out.float(),)
        )
        return None, None, d_packed.to(packed.dtype)


def residuals_low_out_plain(g: GridSpec, packed: torch.Tensor) -> torch.Tensor:
    """The plain version of the bf16-output kernels: the staged residuals
    of the upcast fields, rounded to bf16."""
    return _residuals_packed_plain(g, packed.float()).to(torch.bfloat16)


def _residuals_packed_plain(g: GridSpec, packed: torch.Tensor) -> torch.Tensor:
    rs, ru = residuals_plain(g, unpack_fields(packed))
    return torch.cat([rs[None], ru], dim=0)


def _loss_terms_plain(g: GridSpec, w: PhysWeights, fields: FieldSnapshots) -> torch.Tensor:
    """The staged loss (ops.loss.loss_forward) as a [2] tensor: what the
    backward differentiates, as the JAX VJPs do."""
    return torch.stack(ops_loss.loss_forward(g, w, fields))


# ---------------------------------------------------------------------------
# Public API: six separate arrays
# ---------------------------------------------------------------------------


def residuals_fused(g: GridSpec, fields: FieldSnapshots, precision: str = "f32"):
    """Fused residuals: (R_sigma [nz,ny,nx], R_u [3,nz,ny,nx]); differentiable."""
    return _Residuals.apply(g, precision, *fields)


def loss_backward_fused(g: GridSpec, w: PhysWeights, fields: FieldSnapshots, precision: str = "f32"):
    """Reference-shaped fused backward: (g_sigma, g_u) = (2w/N) R, recomputed
    from the raw fields in one pass without materializing R."""
    if not _uses_kernel(g, fields, precision):
        return loss_backward_plain(g, w, fields)
    dev = fields.sigma_t.device
    gs = torch.empty(g.shape, dtype=torch.float32, device=dev)
    gu = torch.empty((3,) + g.shape, dtype=torch.float32, device=dev)
    _launch(g, _channels(fields), MODE_SCALED, [gs, *gu], scales=ops_loss.loss_scales_f32(g, w))
    return gs, gu


def loss_forward_fused(g: GridSpec, w: PhysWeights, fields: FieldSnapshots, precision: str = "f32"):
    """Fused loss forward: (L_sigma, L_u) from in-kernel per-plane partials
    and a fixed-order sum; residuals are never written to memory.
    Differentiable (staged backward)."""
    loss = _LossForward.apply(g, w, precision, *fields)
    return loss[0], loss[1]


# ---------------------------------------------------------------------------
# Public API: the packed layout [12, nz, ny, nx]
# ---------------------------------------------------------------------------


def residuals_fused_packed(g: GridSpec, packed: torch.Tensor, precision: str = "f32"):
    """[12, nz, ny, nx] (PACKED_ORDER) -> [4, nz, ny, nx] = [R_sigma, R_u];
    differentiable."""
    return _ResidualsPacked.apply(g, precision, packed)


def loss_backward_fused_packed(g: GridSpec, w: PhysWeights, packed: torch.Tensor, precision: str = "f32"):
    """Fused backward on the packed layout -> [4, nz, ny, nx] = (2w/N) R."""
    if not _uses_kernel_packed(g, packed, precision):
        gs, gu = loss_backward_plain(g, w, unpack_fields(packed))
        return torch.cat([gs[None], gu], dim=0)
    out = torch.empty((4,) + g.shape, dtype=torch.float32, device=packed.device)
    _launch(g, list(packed), MODE_SCALED, list(out), scales=ops_loss.loss_scales_f32(g, w))
    return out


def loss_forward_fused_packed(g: GridSpec, w: PhysWeights, packed: torch.Tensor, precision: str = "f32"):
    """Fused loss forward on the packed layout -> (L_sigma, L_u);
    differentiable. The channel views of `packed` are contiguous, so the
    kernel reads the same 12 planes, and autograd gathers their gradients
    into the packed gradient."""
    return loss_forward_fused(g, w, unpack_fields(packed), precision)


def residuals_fused_packed_bf16(g: GridSpec, packed_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 [12, nz, ny, nx] (PACKED_ORDER) -> bf16 [4, nz, ny, nx]
    residuals, float32 arithmetic in between: half the bytes of the f32
    entry point (32 B a cell against 64). Differentiable: the input's
    gradient is the float32 adjoint of the upcast input, rounded to bf16."""
    return _ResidualsPackedLowOut.apply(g, "bf16", packed_bf16)


def residuals_fused_packed_mixed_out(g: GridSpec, packed: torch.Tensor) -> torch.Tensor:
    """float32 [12, nz, ny, nx] -> bf16 [4, nz, ny, nx] residuals (56 B a
    cell). Differentiable: the float32 adjoint of the upcast cotangent."""
    return _ResidualsPackedLowOut.apply(g, "mixed_out", packed)
