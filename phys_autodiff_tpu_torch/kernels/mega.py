"""K3: the MLP -> residual -> loss mega-kernel (port of
phys_autodiff_tpu/pallas/mega.py; CUDA source csrc/mega.cu).

(L_sigma, L_u) from one kernel pass over the folded MLP tables of K2: the
fields at t-dt, t, t+dt never reach device memory. The kernel writes
per-(z plane, tile) partials that K1's finalize pass adds in the fixed
order of ops.loss.sum_partials. It takes any grid (no VMEM feasibility
gate and no staged fallback, which were TPU constraints).

`mega_loss_pipeline` runs the plain PyTorch version (table MLP -> staged
residuals -> plane partials -> sum_partials) for CPU params and launches
the kernel for CUDA params.
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mlp import check_dims, fold_tables, mlp_tables_plain
from phys_autodiff_tpu_torch.kernels.residuals import finalize_partials, num_tiles
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

# z rows a block marches over; each block recomputes one row below and one
# above its range (the TPU kernel carried them across its sequential grid).
ZROWS = 8


def mega_partials_plain(g: GridSpec, ab, cd, w2t, b2) -> torch.Tensor:
    """The plain version of the kernel: plane partials [2, nz]."""
    sigma, u = mlp_tables_plain(ab, cd, w2t, b2)
    fields = FieldSnapshots(sigma[0], sigma[1], sigma[2], u[0], u[1], u[2])
    return ops_loss.plane_partials(*ops_stencil.residuals(g, fields))


def _mega_partials(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2):
    h = ab.shape[0]
    dev = ab.device
    tile_parts = torch.empty((2, g.nz, num_tiles(g)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_partials(
            ab.data_ptr(), cd.data_ptr(), w2t.data_ptr(), b2.data_ptr(), tile_parts.data_ptr(),
            g.nx, g.ny, g.nz, h, ZROWS, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            _build.stream_ptr(dev),
        )
    _build.check(err, "mega kernel")
    _build.LAUNCHES["mega"] += 1
    return finalize_partials(g, w, tile_parts)


def mega_loss_pipeline(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """(L_sigma, L_u) from ONE kernel pass: MLP -> fields (registers and
    shared memory only) -> residuals -> per-plane partials -> fixed-order
    sum."""
    _build.check_precision(precision)
    check_dims(cfg, params)
    tables = fold_tables(g, cfg, params, slice_times(t, g.dt))
    if not _build.uses_kernel(*params.values()):
        parts = mega_partials_plain(g, *tables)
        return ops_loss.sum_partials(g, w, parts)
    _, loss = _mega_partials(g, w, *tables)
    return loss[0], loss[1]
