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
memory of a block in its first pass (K3's body: W2T and CD rows), which
grows with H: `mega_fits` holds for H <= 1628 on an H100 (227 KB a block).
Its scratch in device memory grows with the grid: g and the t slice
(32 B a cell) plus the dAB partials (4 H / ZROWS bytes a cell, 64 B at
H = 128), about 113 MB at 128x96x96.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega import mega_partials_plain
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, check_dims, fold_tables
from phys_autodiff_tpu_torch.kernels.residuals import TILE_X, TILE_Y, finalize_partials, num_tiles
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil

# z rows a block owns in both passes (csrc/mega_bwd.cu ZC).
ZROWS = 8
_THREADS = TILE_X * TILE_Y
_WINDOW = (TILE_X + 2) * (TILE_Y + 2)
#: Shared memory a block may use on an H100 (bytes).
SMEM_LIMIT = 232448


def smem_bytes(h: int) -> int:
    """Dynamic shared memory of the first pass at hidden width h, the larger
    of the two (csrc/mega.cuh mega_smem_bytes; the adjoint pass takes a
    fixed 64 KB)."""
    return 4 * (2 * 4 * _WINDOW + 2 * _THREADS // 32 + 4 + 4 * h + (ZROWS + 2) * h * 3)


def mega_supported(g: GridSpec) -> bool:
    """Every central or upwind grid, periodic or clamp, of any extent."""
    return g.scheme in ("central", "upwind")


def mega_fits(g: GridSpec, h: int = 128) -> bool:
    """The first pass's shared memory fits a block (H <= 1628)."""
    return smem_bytes(h) <= SMEM_LIMIT


def num_subsets(h: int) -> int:
    """Cell subsets of a tile in the MLP backward: thread (h, subset)
    walks one subset, so H * subsets threads fill the block."""
    return max(1, _THREADS // h)


def _check_gates(g: GridSpec, h: int) -> None:
    if not mega_supported(g):
        raise ValueError(f"the backward mega-kernel takes central or upwind, not {g.scheme!r}")
    if not mega_fits(g, h):
        raise ValueError(
            f"H={h} needs {smem_bytes(h)} B of shared memory a block; "
            f"the backward mega-kernel fits up to {SMEM_LIMIT} B"
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
    nsub = num_subsets(h)
    nzr = -(-g.nz // ZROWS)
    ntiles = num_tiles(g)
    nz, ny, nx = g.shape

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tile_parts = empty(2, nz, ntiles)
    gbuf, fbuf = empty(4, nz, ny, nx), empty(4, nz, ny, nx)
    dab_part = empty(nzr, h, ny, nx)
    dcd_part = empty(nz, ntiles * nsub, h, 3)
    dw2_part = empty(ntiles * nzr * nsub, 4, h)
    db2_part = empty(ntiles * nzr, 4)
    dab, dcd, dw2t, db2 = empty(h, ny, nx), empty(nz, h, 3), empty(4, h), empty(4)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_bwd(
            *[x.data_ptr() for x in (ab, cd, w2t, b2, tile_parts, gbuf, fbuf, dab_part,
                                     dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2)],
            nx, ny, nz, h, nsub, int(g.periodic), int(g.scheme == "upwind"),
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
