"""K3: the MLP -> residual -> loss mega-kernel (port of
phys_autodiff_tpu/pallas/mega.py; CUDA source csrc/mega.cu).

(L_sigma, L_u) from one kernel pass over the folded MLP tables of K2: the
fields at t-dt, t, t+dt never reach device memory. The kernel runs the
forward of the tiled MLP core (the routine K2 and K4's fields pass share)
on the persistent walk of kernels/walk.py: each block carries its window
of t-slice rows from chunk to chunk along each run of one tile's rows in
its range, and evaluates the rows just below and above a run once. It writes per-(z plane, tile) partials that K1's finalize pass adds
in the fixed order of ops.loss.sum_partials; they are the partials K2 ->
K1 give for the same tables.

The TPU gates (VMEM feasibility, lane alignment) do not apply: the kernel
takes any grid and both schemes, periodic or clamp. Its one limit is the
shared memory of a block (the window and slice-difference rings, the CD
rows and W2), which grows with H: `mega_fwd_fits` holds for H <= 1908 on an H100,
every H that K4 takes. The kernel raises above that; the fused training
loss (train/slab_grad.make_fused_loss) routes a wider MLP to K2 -> K1.

`mega_loss_pipeline` runs the plain PyTorch version (table MLP -> staged
residuals -> plane partials -> sum_partials) for CPU params and launches
the kernel for CUDA params. It is differentiable in the params and a
tensor t: an autograd.Function whose backward is autograd through the
staged loss (the JAX custom_vjp, pallas/mega.py:553-587). The training
step overrides that backward with K4 or the slab-recompute gradient
(train/slab_grad.make_fused_loss).

precision="bf16" runs the bf16 kernel (layer 2 on the tensor cores, the
chain K2's bf16 tier gives each field value, so its loss equals K2 bf16 ->
K1's to the bit; H <= 1904); "f32_high" and "bf16x3" run the f32 kernel, as
the JAX package computes them in f32 arithmetic (pallas/mega.py:347-351).
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, check_dims, fold_tables, mlp_tables_plain
from phys_autodiff_tpu_torch.kernels.residuals import finalize_partials, num_tiles
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import generate_fields, slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

# Rows of a chunk (csrc/mega.cu ZF).
ZROWS = 3
#: Shared memory a block may use on an H100 (bytes), and what the kernel
#: takes of it statically (the rows' warp sums).
SMEM_LIMIT = 232448
SMEM_STATIC = 4 * 2 * 8 * (ZROWS + 1)
#: ... and the bf16 kernel (those and the chunk's descriptor, seven ints).
SMEM_STATIC_BF16 = SMEM_STATIC + 4 * 7


def smem_bytes(h: int, tier: str = "f32") -> int:
    """Dynamic shared memory of the kernel at hidden width h (csrc/mega.cu
    mega_smem_bytes): W2 (f32: [HP] float4; bf16: its B fragments, the same
    16 B a hidden unit), the CD table [HP][ZROWS + 2][4] (the chunk's rows
    and a run's two outer rows, three slices each, padded to a float4),
    the window ring [ZROWS + 3][4][34 x 10] and the ring of t+dt minus t-dt
    [ZROWS + 1][4][256]; HP = h padded to a multiple of 4 (f32) or of 16
    (bf16)."""
    hp = (h + 3) & ~3 if tier == "f32" else (h + 15) & ~15
    return 4 * (hp * (4 + 4 * (ZROWS + 2)) + (ZROWS + 3) * 4 * 340 + (ZROWS + 1) * 4 * 256)


def mega_fwd_fits(g: GridSpec, h: int = 128, tier: str = "f32") -> bool:
    """K3 takes hidden width h on grid g (every grid; 1 <= H <= 1908 in f32,
    1904 in bf16)."""
    return h >= 1 and smem_bytes(h, tier) + (SMEM_STATIC if tier == "f32" else SMEM_STATIC_BF16) <= SMEM_LIMIT


def _check_gate(g: GridSpec, h: int, tier: str = "f32") -> None:
    if not mega_fwd_fits(g, h, tier):
        raise ValueError(
            f"{'K3' if tier == 'f32' else f'K3 ({tier})'}: H={h} needs "
            f"{smem_bytes(h, tier) + (SMEM_STATIC if tier == 'f32' else SMEM_STATIC_BF16)} B of "
            f"shared memory a block; the "
            f"mega kernel fits up to {SMEM_LIMIT} B (H <= {_build.gate_top(lambda x: mega_fwd_fits(g, x, tier))})"
        )


def mega_partials_plain(g: GridSpec, ab, cd, w2t, b2, tier: str = "f32") -> torch.Tensor:
    """The plain version of the kernel: plane partials [2, nz], layer 2 in
    the arithmetic of `tier` ("f32" or "bf16")."""
    sigma, u = mlp_tables_plain(ab, cd, w2t, b2, tier)
    fields = FieldSnapshots(sigma[0], sigma[1], sigma[2], u[0], u[1], u[2])
    return ops_loss.plane_partials(*ops_stencil.residuals(g, fields))


def _mega_partials(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, tier: str = "f32"):
    h = ab.shape[0]
    _check_gate(g, h, tier)
    dev = ab.device
    tile_parts = torch.empty((2, g.nz, num_tiles(g)), dtype=torch.float32, device=dev)
    fn = _build.lib().pat_mega_partials if tier == "f32" else _build.lib().pat_mega_partials_bf16
    with torch.cuda.device(dev):
        err = fn(
            ab.data_ptr(), cd.data_ptr(), w2t.data_ptr(), b2.data_ptr(), tile_parts.data_ptr(),
            g.nx, g.ny, g.nz, h, num_blocks(g), int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            _build.stream_ptr(dev),
        )
    _build.check(err, f"mega kernel ({tier})", "K3", (tile_parts,))
    _build.LAUNCHES["mega" if tier == "f32" else "mega bf16"] += 1
    return finalize_partials(g, w, tile_parts)


def _mega_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str):
    """(L_sigma, L_u) as a [2] tensor: the kernel, or its plain version."""
    tier = _build.check_precision(precision, "K3")
    check_dims(cfg, params)
    tables = fold_tables(g, cfg, params, slice_times(t, g.dt))
    if not _build.uses_kernel(*params.values()):
        return torch.stack(ops_loss.sum_partials(g, w, mega_partials_plain(g, *tables, tier)))
    return _mega_partials(g, w, *tables, tier)[1]


def _staged_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t) -> torch.Tensor:
    """The staged loss [L_sigma, L_u] of the MLP's fields (models.fields ->
    ops.loss): what the backward differentiates."""
    return torch.stack(ops_loss.loss_forward(g, w, generate_fields(g, cfg, params, t, g.dt)))


class _MegaLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w, cfg, precision, t, *weights):
        ctx.g, ctx.w, ctx.cfg, ctx.t = g, w, cfg, t
        ctx.save_for_backward(*weights)
        return _mega_loss(g, w, cfg, dict(zip(_PARAM_KEYS, weights)), t, precision)

    @staticmethod
    def backward(ctx, d_loss):
        t = ctx.t
        t_grad = isinstance(t, torch.Tensor) and ctx.needs_input_grad[4]
        with torch.enable_grad():
            ws = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            tt = t.detach().requires_grad_() if t_grad else t
            loss = _staged_loss(ctx.g, ctx.w, ctx.cfg, dict(zip(_PARAM_KEYS, ws)), tt)
        grads = torch.autograd.grad(loss, ws + ([tt] if t_grad else []), d_loss)
        return (None, None, None, None, grads[4] if t_grad else None, *grads[:4])


def mega_loss_pipeline(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """(L_sigma, L_u) from ONE kernel pass: MLP -> fields (registers and
    shared memory only) -> residuals -> per-plane partials -> fixed-order
    sum. Differentiable (staged backward)."""
    loss = _MegaLoss.apply(g, w, cfg, precision, t, *(params[k] for k in _PARAM_KEYS))
    return loss[0], loss[1]
