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

The shard-local build (`table_loss_and_grad_shard`; JAX
`_build_bwd_call(nz_local=...)`, pallas/mega_bwd.py:568-800) runs the same
kernel on the rows [z0, z0 + nz_local) of the global grid: the fields and
residuals of two halo rows a side recomputed from the replicated tables,
the clamp edges on global rows, each owned row's cotangent whole. Its
plain version recomputes those rows itself (`owned_cotangent_plain`);
`table_loss_and_grad_shard_ref` is the float64 referee the card holds it
to; `mega_loss_and_grad_sharded` runs it a rank over a parallel.mesh.ZMesh.

precision="bf16" runs the bf16 kernel: layer 2's forward, dW2 and da1 with
bf16 operands and float32 sums on the tensor cores (csrc/mlp_mma.cuh, the
adjoint pass's own walk in csrc/mega_bwd.cu; H <= 1360), as the TPU
computes them (pallas/mega_bwd.py:705-750; on the CPU JAX's interpret mode
keeps da1 in float32, ROADMAP.md R2); "f32_high" and "bf16x3" run the f32
kernel, as the JAX package computes them in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega import mega_partials_plain
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, _bf16, check_dims, fold_tables, mlp_tables_plain
from phys_autodiff_tpu_torch.kernels.residuals import (
    TILE_X, TILE_Y, finalize_partials, num_tiles, sum_plane_partials,
)
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.utils.timing import annotate

# Rows of a chunk of the adjoint pass (csrc/mega_bwd.cu ZC).
ZROWS = 8
_THREADS = TILE_X * TILE_Y
#: Shared memory a block may use on an H100 (bytes), and what the adjoint
#: pass takes of it statically (its block-sum scratch).
SMEM_LIMIT = 232448
SMEM_STATIC = 64
#: The widest H of the bf16 tier: the top its gate has had since the tier
#: was ported (the widths it is held to its plain version at on the card);
#: its adjoint pass's layout fits far past it.
BF16_MAX_H = 1360


def smem_bytes(h: int, tier: str = "f32") -> int:
    """Dynamic shared memory of the adjoint pass at hidden width h, the
    larger of K4's two passes (csrc/mega_bwd.cu adjoint_smem_bytes). f32:
    dF and g/(2dt) [ZROWS][256] float4 each, the CD rows [ZROWS][HP][3], W2
    [HP] float4 and the dW2T sums [HP][4], HP = h padded to a multiple of 4.
    bf16 (adjoint_smem_bf16): the cotangents [dF | g/(2dt)] in bf16, 16 B a
    cell, of two chunks, the dW2T sums [HP][4], each warp's dCD rows
    [8][ZROWS][3][16][2] and each thread's db2 sums (16 B), HP padded to 16
    (the CD rows are read through L1)."""
    if tier == "f32":
        hp = (h + 3) & ~3
        return 32 * ZROWS * _THREADS + 4 * (ZROWS * hp * 3 + 8 * hp)
    hp = (h + 15) & ~15
    return 2 * ZROWS * _THREADS * 16 + 16 * hp + 4 * 8 * ZROWS * 3 * 16 * 2 + 16 * _THREADS


def mega_supported(g: GridSpec) -> bool:
    """Every central or upwind grid, periodic or clamp, of any extent."""
    return g.scheme in ("central", "upwind")


def mega_fits(g: GridSpec, h: int = 128, tier: str = "f32") -> bool:
    """The adjoint pass's shared memory fits a block (1 <= H <= 1300 in f32);
    bf16: 1 <= H <= BF16_MAX_H = 1360."""
    top = BF16_MAX_H if tier == "bf16" else h
    return 1 <= h <= top and smem_bytes(h, tier) + SMEM_STATIC <= SMEM_LIMIT


def dab_slots(g: GridSpec) -> int:
    """dAB partial slots of [H, 256]: block b's rows of tile T go to slot
    b + T, which is one-to-one because the ranges are contiguous."""
    return num_blocks(g) + num_tiles(g) - 1


def _check_gates(g: GridSpec, h: int, tier: str = "f32") -> None:
    if not mega_supported(g):
        raise ValueError(f"the backward mega-kernel takes central or upwind, not {g.scheme!r}")
    if not mega_fits(g, h, tier):
        raise ValueError(
            f"H={h} needs {smem_bytes(h, tier) + SMEM_STATIC} B of shared memory a block; the backward "
            f"mega-kernel ({tier}) fits up to {SMEM_LIMIT} B (H <= {_build.gate_top(lambda x: mega_fits(g, x, tier))})"
        )


# ---------------------------------------------------------------------------
# Table gradients: the kernel and its plain version
# ---------------------------------------------------------------------------


def table_loss_and_grad_plain(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, tier: str = "f32"):
    """The plain version of the kernel: (loss [2], (dAB, dCD, dW2T, db2)) by
    autograd through the table MLP (layer 2 in the arithmetic of `tier`:
    the bf16 tier rounds the operands of dW2T and da1 too), the staged
    residuals, the plane partials and their fixed-order sum."""
    with torch.enable_grad():
        tables = [x.detach().requires_grad_() for x in (ab, cd, w2t, b2)]
        ls, lu = ops_loss.sum_partials(g, w, mega_partials_plain(g, *tables, tier))
        grads = torch.autograd.grad(ls + lu, tables)
    return torch.stack([ls, lu]).detach(), grads


def _launch(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, tier: str, z0: int, nz_local: int, counter: str):
    """One launch of the kernel of `tier` for the rows [z0, z0 + nz_local) of
    g (the whole grid: z0 = 0, nz_local = nz): (plane partials [2, nz_local],
    the loss [2] (the whole grid's only), (dAB, dCD [nz_local, H, 3], dW2T,
    db2)), the sums over the owned rows."""
    h, dev = ab.shape[0], ab.device
    _check_gates(g, h, tier)
    _build.check_shape(cd, (g.nz, h, 3), "CD")
    g_own = dataclasses.replace(g, nz=nz_local)
    nb = nz_local if nz_local == g.nz else nz_local + 2 * HALO
    nblk, ntiles = num_blocks(g_own), num_tiles(g)
    ny, nx = g.ny, g.nx

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tile_parts = empty(2, nb, ntiles)
    gbuf, fbuf = empty(4, nb, ny, nx), empty(12, nb, ny, nx)
    dab_part = empty(dab_slots(g_own), h, _THREADS)
    dcd_part = empty(nz_local, ntiles, h, 3)
    dw2_part, db2_part = empty(nblk, 4, h), empty(nblk, 4)
    dab, dcd, dw2t, db2 = empty(h, ny, nx), empty(nz_local, h, 3), empty(4, h), empty(4)
    fn = _build.lib().pat_mega_bwd if tier == "f32" else _build.lib().pat_mega_bwd_bf16
    with torch.cuda.device(dev):
        err = fn(
            *[x.data_ptr() for x in (ab, cd, w2t, b2, tile_parts, gbuf, fbuf, dab_part,
                                     dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2)],
            nx, ny, g.nz, z0, nz_local, h, nblk, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            *[float(s) for s in ops_loss.loss_scales_f32(g, w)],
            _build.stream_ptr(dev),
        )
    _build.check(err, f"backward mega kernel ({tier})", "K4", (tile_parts, dab, dcd, dw2t, db2))
    _build.LAUNCHES[counter] += 1
    parts, loss = finalize_partials(dataclasses.replace(g, nz=nb), w, tile_parts)
    hz = (nb - nz_local) // 2
    return parts[:, hz : hz + nz_local], loss, (dab, dcd, dw2t, db2)


def table_loss_and_grad(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, tier: str = "f32"):
    """(loss [2], (dAB, dCD, dW2T, db2)) from the tables: the kernel of `tier`
    ("f32" or "bf16") for CUDA tensors, the plain version for CPU tensors."""
    if not _build.uses_kernel(ab, cd, w2t, b2):
        return table_loss_and_grad_plain(g, w, ab, cd, w2t, b2, tier)
    _, loss, grads = _launch(g, w, ab, cd, w2t, b2, tier, 0, g.nz, "mega_bwd" if tier == "f32" else "mega_bwd bf16")
    return loss, grads


# ---------------------------------------------------------------------------
# The shard-local build: a shard's rows, the halo recomputed
# ---------------------------------------------------------------------------

#: Halo rows a side of a shard's fields (the adjoint of a field row reads
#: the residuals beside it, and those the fields beside them).
HALO = 2


def check_shard(g: GridSpec, z0: int, nz_local: int) -> None:
    if nz_local < 1 or z0 < 0 or z0 + nz_local > g.nz or (nz_local == g.nz and z0 != 0):
        raise ValueError(f"rows [{z0}, {z0 + nz_local}) are not a shard of nz={g.nz}")


def halo_rows(g: GridSpec, z0: int, nz_local: int, device=None) -> torch.Tensor:
    """The global rows z0 - 2 .. z0 + nz_local + 1 of a shard, wrapped
    (periodic) or clamped: the rows whose fields the shard-local kernels
    compute (K5's caller encodes them)."""
    return ops_stencil.z_rows(g, z0 - HALO, z0 + nz_local + HALO, device)


def residual_range(g: GridSpec, z0: int, nz_local: int) -> tuple[int, int]:
    """The residual rows [a, b] (unwrapped) whose residuals depend on a field
    row of [z0, z0 + nz_local): one row beyond each end, within the grid
    when clamped, the whole ring when the shard and its two neighbours'
    rows would wrap onto each other."""
    if g.periodic:
        return (0, g.nz - 1) if nz_local + 2 > g.nz else (z0 - 1, z0 + nz_local)
    return max(z0 - 1, 0), min(z0 + nz_local, g.nz - 1)


def owned_cotangent_plain(g: GridSpec, w: PhysWeights, fields_fn, z0: int, nz_local: int, device):
    """The shard-local backward written out for the plain versions of K4 and
    K5: the fields of the global rows that the residuals of
    residual_range(...) read (fields_fn(rows) -> (sigma [3, R, ny, nx],
    u [3, 3, R, ny, nx]), differentiable), the staged residuals of those
    rows (ops.stencil.residuals_zext), their weighted squares / N by
    autograd, and the field cotangent kept on the owned rows only. Returns
    (raw plane partials of the owned rows [2, nz_local], (sigma, u) and
    their cotangents, zero off the owned rows), for the caller to pull
    back. Independent of the full-grid plain version's slicing."""
    a, b = residual_range(g, z0, nz_local)
    uniq, inv = torch.unique(ops_stencil.z_rows(g, a - 1, b + 2, device), return_inverse=True)
    ws, wu = float(np.float32(w.w_sigma)), float(np.float32(w.w_u))
    inv_n = float(ops_loss.inv_n_f32(g))
    with torch.enable_grad():
        sigma, u = fields_fn(uniq)
        fs, fu = sigma.detach().requires_grad_(), u.detach().requires_grad_()
        rs, ru = ops_stencil.residuals_zext(g, fs[:, inv], fu[:, :, inv])
        parts = ops_loss.plane_partials(rs, ru)
        d_s, d_u = torch.autograd.grad(ws * inv_n * parts[0].sum() + wu * inv_n * parts[1].sum(), [fs, fu])
    own = ((uniq >= z0) & (uniq < z0 + nz_local)).to(d_s.dtype)
    d_s, d_u = d_s * own[None, :, None, None], d_u * own[None, None, :, None, None]
    return parts[:, z0 - a : z0 - a + nz_local].detach(), (sigma, u), (d_s, d_u), uniq


def table_loss_and_grad_shard_plain(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, z0: int, nz_local: int,
                                    tier: str = "f32"):
    """The plain version of the shard-local kernel: (raw plane partials of
    the owned rows [2, nz_local], (dAB, dCD [nz_local, H, 3], dW2T, db2))
    with every field row's cotangent counted at its owner (the rows [z0,
    z0 + nz_local)); the shards' dAB, dW2T and db2 add up to the whole
    grid's. owned_cotangent_plain pulled back through the table MLP
    (layer 2 in the arithmetic of `tier`)."""
    check_shard(g, z0, nz_local)
    with torch.enable_grad():
        tables = [x.detach().requires_grad_() for x in (ab, cd, w2t, b2)]

        def fields_fn(rows):
            return mlp_tables_plain(tables[0], tables[1][rows], tables[2], tables[3], tier)

        parts, outs, cts, _ = owned_cotangent_plain(g, w, fields_fn, z0, nz_local, ab.device)
        dab, dcd, dw2t, db2 = torch.autograd.grad(outs, tables, cts)
    return parts, (dab, dcd[z0 : z0 + nz_local], dw2t, db2)


def table_loss_and_grad_shard_ref(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, z0: int, nz_local: int,
                                  tier: str = "f32"):
    """The referee the shard-local kernel is held to on the card: the field
    cotangents of the owned rows as the plain version takes them
    (owned_cotangent_plain), pulled back through the table MLP in float64
    by hand (layer 2's operands rounded to bf16 first in the bf16 tier, as
    the kernel rounds them); the results rounded to float32. A shard's dAB
    is a partial sum in which the t -+ dt legs (1/(2 dt) times the t
    slice's) nearly cancel; float32 autograd adds them slice by slice and
    loses up to 1e-2 of an edge shard's dAB at 128x96x96, the kernel adds
    them per cell first."""
    check_shard(g, z0, nz_local)

    def fields_fn(rows):
        return mlp_tables_plain(ab, cd[rows], w2t, b2, tier)

    parts, _, (d_s, d_u), rows = owned_cotangent_plain(g, w, fields_fn, z0, nz_local, ab.device)
    gy = torch.cat([d_s[:, :, None], torch.movedim(d_u, 1, 2)], dim=2)  # [S, U, 4, ny, nx]
    z1 = ab[None, None] + cd[rows].permute(2, 0, 1)[:, :, :, None, None]  # [S, U, H, ny, nx]
    a1, gyr, w2 = torch.clamp_min(z1, 0.0), gy, w2t
    if tier == "bf16":
        a1, gyr, w2 = _bf16(a1), _bf16(gy), _bf16(w2t)
    gyr = gyr.double()
    dz1 = torch.einsum("oh,suoyx->suhyx", w2.double(), gyr) * (z1 > 0)
    dcd = torch.zeros(cd.shape, dtype=torch.float64, device=cd.device)
    dcd[rows] = dz1.sum(dim=(3, 4)).permute(1, 2, 0)
    dw2t = torch.einsum("suoyx,suhyx->oh", gyr, a1.double())
    grads = (dz1.sum(dim=(0, 1)), dcd[z0 : z0 + nz_local], dw2t, gy.double().sum(dim=(0, 1, 3, 4)))
    return parts, tuple(x.float() for x in grads)


def table_loss_and_grad_shard(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, z0: int, nz_local: int,
                              tier: str = "f32"):
    """The shard-local kernel (the rows [z0, z0 + nz_local) of g, the halo
    recomputed, the clamp edges on global rows) of `tier` for CUDA tensors,
    its plain version for CPU tensors: (raw plane partials [2, nz_local],
    (dAB, dCD [nz_local, H, 3], dW2T, db2)), the owned rows' part of the
    sums."""
    check_shard(g, z0, nz_local)
    if not _build.uses_kernel(ab, cd, w2t, b2):
        return table_loss_and_grad_shard_plain(g, w, ab, cd, w2t, b2, z0, nz_local, tier)
    counter = "mega_bwd shard" if tier == "f32" else "mega_bwd bf16 shard"
    parts, _, grads = _launch(g, w, ab, cd, w2t, b2, tier, z0, nz_local, counter)
    return parts, grads


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _fold_with_grad(g, cfg, params, t):
    """Leaf copies of the params and t, and the folded tables that autograd
    pulls back to them."""
    dev = params["W1"].device
    with annotate("pat.fold"), torch.enable_grad():
        p = [params[k].detach().requires_grad_() for k in _PARAM_KEYS]
        if isinstance(t, torch.Tensor):
            tt = t.detach().to(device=dev, dtype=torch.float32)
        else:  # a fill, not a host-to-device copy
            tt = torch.full((), float(np.float32(t)), dtype=torch.float32, device=dev)
        tt.requires_grad_()
        tables = fold_tables(g, cfg, dict(zip(_PARAM_KEYS, p)), slice_times(tt, g.dt))
    return p, tt, tables


def _loss_and_grad(g, w, cfg, params, t, precision, table_fn):
    tier = _build.check_precision(precision, "K4")
    check_dims(cfg, params)
    p, tt, tables = _fold_with_grad(g, cfg, params, t)
    loss, d_tables = table_fn(g, w, *(x.detach() for x in tables), tier)
    with annotate("pat.fold.pullback"):
        grads = torch.autograd.grad(tables, p + [tt], d_tables)
    return loss[0] + loss[1], (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])


def mega_loss_and_grad(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """(loss, (grad_params, grad_t)) from ONE call of the backward
    mega-kernel (CUDA params) or its plain version (CPU params)."""
    return _loss_and_grad(g, w, cfg, params, t, precision, table_loss_and_grad)


def mega_loss_and_grad_sharded(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, mesh, precision: str = "f32"):
    """Returns fn(params, t) -> (loss, (grad_params, grad_t)) over the z mesh
    (parallel/mesh.ZMesh; JAX pallas/mega_bwd.py:872-955): each rank runs
    the shard-local kernel (its plain version for CPU params) on its rows,
    the halo recomputed from the replicated tables rather than exchanged;
    the table-gradient partials are all-reduced, the owned rows' dCD
    all-gathered, and the loss chained from the gathered plane partials in
    global z order (sum_plane_partials), so it is the whole-grid kernel's
    loss on any mesh. Nothing grid-sized exists on a rank."""
    tier = _build.check_precision(precision, "K4")
    z0, nz_local = mesh.rows(g.nz)

    def loss_and_grad(params, t):
        check_dims(cfg, params)
        p, tt, tables = _fold_with_grad(g, cfg, params, t)
        parts, (dab, dcd, dw2t, db2) = table_loss_and_grad_shard(
            g, w, *(x.detach() for x in tables), z0, nz_local, tier
        )
        loss = sum_plane_partials(g, w, mesh.all_gather(parts, 1))
        d_tables = (mesh.all_reduce(dab), mesh.all_gather(dcd, 0), mesh.all_reduce(dw2t), mesh.all_reduce(db2))
        grads = torch.autograd.grad(tables, p + [tt], d_tables)
        return loss[0] + loss[1], (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])

    return loss_and_grad


def mega_loss_and_grad_plain(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """The plain version of mega_loss_and_grad, on any device."""
    return _loss_and_grad(g, w, cfg, params, t, precision, table_loss_and_grad_plain)
