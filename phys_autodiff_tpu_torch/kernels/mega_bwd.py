"""K4: the backward mega-kernel (port of phys_autodiff_tpu/pallas/mega_bwd.py;
CUDA source csrc/mega_bwd.cu).

`mega_loss_and_grad` returns the loss AND the gradients of the MLP params
and of t from one kernel call: the kernel computes the loss partials and
the gradients of the folded tables (dAB, dCD, dW2T, db2); autograd of the
folds (kernels/mlp.fold_tables) pulls those back to (W1, b1, W2, b2, t), as
the JAX package pulls them back with jax.vjp (mega_bwd.py:850-868).

For CPU params it runs the plain version: autograd through the table MLP ->
staged residuals -> plane partials -> fixed-order sum, pulled back the same
way (`mega_loss_and_grad_plain` runs it on any device). For CUDA params it
launches the kernel or raises.

Gates, re-decided for the card. The TPU gates were lane alignment
(`mega_supported`) and VMEM (`mega_fits`). The kernel here takes any grid
and both schemes, periodic or clamp, including ragged tiles and nz = 1, so
`mega_supported` holds for every GridSpec. Its one limit is the shared
memory of a block in its adjoint pass (the chunk's cotangents, its CD rows,
W2 and the dW2T sums; csrc/mega_bwd.cu), which grows with H: `mega_fits`
holds for H <= 1300 on an H100 (227 KB a block). Its scratch in device
memory grows with the grid: the fields of the three slices and g (64 B a
cell) plus the dAB partials, one [H, 256] slot a (block, tile) of the
persistent walk (`dab_slots`; 41 MB at 128x96x96, H = 128), about 116 MB
there.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega import mega_partials_plain
from phys_autodiff_tpu_torch.kernels.mega_ngp import num_blocks
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, check_dims, fold_tables
from phys_autodiff_tpu_torch.kernels.residuals import TILE_X, TILE_Y, finalize_partials, num_tiles
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil

# Rows of a chunk of the adjoint pass (csrc/mega_bwd.cu ZC).
ZROWS = 8
_THREADS = TILE_X * TILE_Y
#: Shared memory a block may use on an H100 (bytes), and what the adjoint
#: pass takes of it statically (its block-sum scratch).
SMEM_LIMIT = 232448
SMEM_STATIC = 64


def smem_bytes(h: int) -> int:
    """Dynamic shared memory of the adjoint pass at hidden width h, the
    larger of K4's two passes (csrc/mega_bwd.cu adjoint_smem_bytes): dF and
    g/(2dt) [ZROWS][256] float4 each, the CD rows [ZROWS][HP][3], W2 [HP]
    float4 and the dW2T sums [HP][4], HP = h padded to a multiple of 4."""
    hp = (h + 3) & ~3
    return 32 * ZROWS * _THREADS + 4 * (ZROWS * hp * 3 + 8 * hp)


def mega_supported(g: GridSpec) -> bool:
    """Every central or upwind grid, periodic or clamp, of any extent."""
    return g.scheme in ("central", "upwind")


def mega_fits(g: GridSpec, h: int = 128) -> bool:
    """The adjoint pass's shared memory fits a block (1 <= H <= 1300)."""
    return h >= 1 and smem_bytes(h) + SMEM_STATIC <= SMEM_LIMIT


def block_ranges(g: GridSpec) -> list[tuple[int, int]]:
    """The persistent walk of K4's and K6's passes (csrc/mlp_head.cuh
    block_rows): the ntiles * nz tile rows (tile-major, z fastest) dealt in
    contiguous ranges [r0, r1) to num_blocks(g) blocks, in block order."""
    nrows, nblk = num_tiles(g) * g.nz, num_blocks(g)
    return [(b * nrows // nblk, (b + 1) * nrows // nblk) for b in range(nblk)]


def block_of_row(r: int, nrows: int, nblk: int) -> int:
    """The block whose range holds tile row r (csrc/mlp_head.cuh
    block_of_row): how the dAB sum finds the blocks that walked a tile."""
    return ((r + 1) * nblk - 1) // nrows


def dab_slots(g: GridSpec) -> int:
    """dAB partial slots of [H, 256]: block b's rows of tile T go to slot
    b + T, which is one-to-one because the ranges are contiguous."""
    return num_blocks(g) + num_tiles(g) - 1


def _check_gates(g: GridSpec, h: int) -> None:
    if not mega_supported(g):
        raise ValueError(f"the backward mega-kernel takes central or upwind, not {g.scheme!r}")
    if not mega_fits(g, h):
        raise ValueError(
            f"H={h} needs {smem_bytes(h) + SMEM_STATIC} B of shared memory a block; "
            f"the backward mega-kernel fits up to {SMEM_LIMIT} B (H <= 1300)"
        )


# ---------------------------------------------------------------------------
# Table gradients: the kernel and its plain version
# ---------------------------------------------------------------------------


def table_loss_and_grad_plain(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2):
    """The plain version of the kernel: (loss [2], (dAB, dCD, dW2T, db2)) by
    autograd through the table MLP, the staged residuals, the plane
    partials and their fixed-order sum."""
    with torch.enable_grad():
        tables = [x.detach().requires_grad_() for x in (ab, cd, w2t, b2)]
        ls, lu = ops_loss.sum_partials(g, w, mega_partials_plain(g, *tables))
        grads = torch.autograd.grad(ls + lu, tables)
    return torch.stack([ls, lu]).detach(), grads


def table_loss_and_grad(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2):
    """(loss [2], (dAB, dCD, dW2T, db2)) from the tables: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not _build.uses_kernel(ab, cd, w2t, b2):
        return table_loss_and_grad_plain(g, w, ab, cd, w2t, b2)
    h, dev = ab.shape[0], ab.device
    _check_gates(g, h)
    nblk, ntiles = num_blocks(g), num_tiles(g)
    nz, ny, nx = g.shape

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tile_parts = empty(2, nz, ntiles)
    gbuf, fbuf = empty(4, nz, ny, nx), empty(12, nz, ny, nx)
    dab_part = empty(dab_slots(g), h, _THREADS)
    dcd_part = empty(nz, ntiles, h, 3)
    dw2_part, db2_part = empty(nblk, 4, h), empty(nblk, 4)
    dab, dcd, dw2t, db2 = empty(h, ny, nx), empty(nz, h, 3), empty(4, h), empty(4)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_bwd(
            *[x.data_ptr() for x in (ab, cd, w2t, b2, tile_parts, gbuf, fbuf, dab_part,
                                     dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2)],
            nx, ny, nz, h, nblk, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            *[float(s) for s in ops_loss.loss_scales_f32(g, w)],
            _build.stream_ptr(dev),
        )
    _build.check(err, "backward mega kernel")
    _build.LAUNCHES["mega_bwd"] += 1
    _, loss = finalize_partials(g, w, tile_parts)
    return loss, (dab, dcd, dw2t, db2)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _loss_and_grad(g, w, cfg, params, t, precision, table_fn):
    _build.check_precision(precision, "K4")
    check_dims(cfg, params)
    dev = params["W1"].device
    with torch.enable_grad():
        p = [params[k].detach().requires_grad_() for k in _PARAM_KEYS]
        if isinstance(t, torch.Tensor):
            tt = t.detach().to(device=dev, dtype=torch.float32)
        else:  # a fill, not a host-to-device copy
            tt = torch.full((), float(np.float32(t)), dtype=torch.float32, device=dev)
        tt.requires_grad_()
        tables = fold_tables(g, cfg, dict(zip(_PARAM_KEYS, p)), slice_times(tt, g.dt))
    loss, d_tables = table_fn(g, w, *(x.detach() for x in tables))
    grads = torch.autograd.grad(tables, p + [tt], d_tables)
    return loss[0] + loss[1], (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])


def mega_loss_and_grad(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """(loss, (grad_params, grad_t)) from ONE call of the backward
    mega-kernel (CUDA params) or its plain version (CPU params)."""
    return _loss_and_grad(g, w, cfg, params, t, precision, table_loss_and_grad)


def mega_loss_and_grad_plain(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """The plain version of mega_loss_and_grad, on any device."""
    return _loss_and_grad(g, w, cfg, params, t, precision, table_loss_and_grad_plain)
