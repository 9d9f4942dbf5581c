"""K6 and K7: the supervised-fit kernels (port of phys_autodiff_tpu/pallas/fit.py;
CUDA sources csrc/fit.cu and csrc/fit_ngp.cu).

`fit_loss_and_grad` (the coordinate MLP, K6) and `ngp_fit_loss_and_grad`
(the encoded field, K7) return the weighted data MSE against one packed
target and the gradients of the params and of t from one kernel call:

    L = w_sigma mean((sigma - target_sigma)^2) + w_u mean(|u - target_u|^2)

(the reference's weighting, the u term a mean over N cells of the channel
sum), with the plane partials added in the fixed order of
ops.loss.sum_partials. K6 returns the gradients of the folded tables
(dAB, dCD, dW2T, db2) and autograd of the folds pulls them back to (W1, b1,
W2, b2, t), as kernels/mega_bwd does for K4. K7 returns dEnc, dW1c, db1,
dW2 and db2; W1's last row is t db1 (one slice), d_t = W1[-1] . db1, and
autograd pulls dEnc back to the encoder's tables, as kernels/mega_ngp does
for K5. A parameter-free encoding (Fourier) skips dEnc; its empty tables
get a zero gradient. dW2 comes out in W2's own layout [H, 4] from both.

For CPU tensors each wrapper runs its plain version (float32 autograd
through the table MLP or the head and the fixed-order data loss); for CUDA
tensors it launches the kernel or raises. The `*_ref` functions are the
referee the kernels are held to on the card: the float32 forward's values
and ReLU masks, the backward in float64.

On a shard's rows (`fit_table_loss_and_grad_shard`,
`ngp_fit_head_loss_and_grad_shard`; JAX `_build_fit_call(nz_local=...)`
and `_build_ngp_fit_call(nz_local=...)`) K6 and K7 run unchanged on the
sliced CD or encoding rows and target rows, scaled by the global grid's
N (no halo: the data loss has no stencil); `fit_loss_and_grad_sharded`
and `ngp_fit_loss_and_grad_sharded` run them a rank over a ZMesh.

Gates, re-decided for the card. The TPU kernels need ny * nx % 128 == 0
(lane-aligned planes, pallas/fit.py:61-65). These kernels take any grid, so
`fit_supported` holds for every GridSpec (the boundary and the scheme play
no part: the data loss has no stencil). K6 runs on the tiled MLP core
(csrc/mlp_head.cuh, shared with K4); its one limit is a block's shared
memory (a chunk's gy and CD rows, W2 and the dW2T sums, 64 KB + 96 H
bytes: H <= 1724); its scratch is K4's dAB partial slots (`dab_slots`)
and the dCD partials [nz, ntiles, H]. K7 runs on the head core
(csrc/ngp_head.cuh), which takes LF <= 64 and H <= 256 and holds a tile
row's encoding and base / dz1 in a block's shared memory, which bounds
LF x H further (`ngp_fit_fits`). K6 runs the tiers of kernels/_build.TIERS
(bf16 on the tensor cores, a kernel of its own: csrc/fit.cu
bfit::k_fit_bf16, chunks of `fit_zrows_bf16(h)` rows, H <= BF16_MAX_H);
K7 runs TIERS["K7"]: "bf16"
rounds the operands of every head product to bf16 and sums in float32
(pallas/fit.py:440-527), on the fast encode, its plain version written
out (mega_ngp.head_backward_plain), its products on the tensor cores on
the card; the other names run f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega_bwd import check_shard, dab_slots
from phys_autodiff_tpu_torch.kernels.mega_ngp import (
    MAX_H, MAX_LF, SMEM_STATIC, _f32_only, _t_value, _with_value, _zeros_for_unused, head_backward_plain,
    head_smem_bytes,
)
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, _bf16, check_dims, fold_tables, layer2
from phys_autodiff_tpu_torch.kernels.residuals import (
    TILE_X, TILE_Y, finalize_partials, num_tiles, sum_plane_partials,
)
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.utils.timing import annotate

# Rows of a chunk of K6 (csrc/fit.cu ZC).
ZROWS = 16
_THREADS = TILE_X * TILE_Y
#: Shared memory a block may use on an H100 (bytes), and what K6 takes of it
#: statically (the rows' warp sums and the block-sum scratch).
SMEM_LIMIT = 232448
FIT_SMEM_STATIC = 4 * (2 * 8 * ZROWS + 16)
#: ... and what its bf16 kernel takes statically (the block-sum scratch).
FIT_SMEM_STATIC_BF16 = 4 * 16
#: The widest H of K6 bf16 (its layout would take more; the gate's top
#: since the tier was ported).
BF16_MAX_H = 1600
#: The most a block may take, static included, with two blocks an SM.
_SMEM_2BLK_TOTAL = 115712


def fit_supported(g: GridSpec) -> bool:
    """Every grid: the kernels take any extent, ragged tiles and nz = 1
    included, and the data loss has no stencil, so neither the boundary
    nor the scheme matters."""
    return True


def fit_smem_bytes(h: int, tier: str = "f32") -> int:
    """Dynamic shared memory of K6 (csrc/fit.cu fit_smem_bytes): gy
    [ZROWS][256] float4, the CD rows [ZROWS][HP], W2 [HP] float4 and the
    dW2T sums [HP][4], HP = h padded to a multiple of 4. bf16: its own
    layout at the chunk depth fit_zrows_bf16(h) (_fit_bf16_layout)."""
    if tier == "f32":
        hp = (h + 3) & ~3
        return 16 * ZROWS * _THREADS + 4 * (ZROWS * hp + 8 * hp)
    return _fit_bf16_layout(h, fit_zrows_bf16(h))


def _fit_bf16_layout(h: int, zc: int) -> int:
    """Dynamic shared memory of K6 bf16 at zc rows a chunk (csrc/fit.cu
    bfit::fit_layout): W2's B fragments (16 B a hidden unit), the dW2T sums
    [HP][4], the CD rows of two chunks [2][zc][HP], the chunk's gy as one
    16-byte bf16 row a cell and row pair [zc / 2][256], each warp's dCD rows
    [8][zc][16] and the rows' loss sums [zc][8][2][2] (float32 but gy), HP =
    h padded to 16."""
    hp = (h + 15) & ~15
    return 16 * hp + 16 * hp + 8 * zc * hp + (zc // 2) * _THREADS * 16 + 4 * 8 * zc * 16 + 4 * zc * 32


def fit_zrows_bf16(h: int) -> int:
    """The chunk depth of K6 bf16 (csrc/fit.cu bfit::fit_zc): the deepest of
    24, 16, 8 and 4 rows that keeps two blocks an SM, else the deepest of
    16, 8 and 4 that fits a block."""
    for zc in (24, 16, 8, 4):
        if _fit_bf16_layout(h, zc) + FIT_SMEM_STATIC_BF16 <= _SMEM_2BLK_TOTAL:
            return zc
    for zc in (16, 8, 4):
        if _fit_bf16_layout(h, zc) + FIT_SMEM_STATIC_BF16 <= SMEM_LIMIT:
            return zc
    return 4


def fit_fits(h: int, tier: str = "f32") -> bool:
    """K6's shared memory fits a block (1 <= H <= 1724 in f32), and in
    bf16 1 <= H <= BF16_MAX_H = 1600 (its layout fits further)."""
    static = FIT_SMEM_STATIC if tier == "f32" else FIT_SMEM_STATIC_BF16
    return h >= 1 and (tier == "f32" or h <= BF16_MAX_H) and fit_smem_bytes(h, tier) + static <= SMEM_LIMIT


def ngp_fit_smem_bytes(lf: int, h: int, tier: str = "f32") -> int:
    """Dynamic shared memory of K7: "f32" the head core's layout (gy one
    float4 a cell); "bf16" its own (csrc/fit_ngp.cu bfk::fit_layout with
    fit_ndz's dz1 buffers): W2's fragments, tb1, W1c's two fragment layouts,
    the rows' loss sums, gy of two rows (16 B a cell), a ring of three
    encoding rows and one or two dz1 rows in bf16 (row stride 264), or the
    cell splits' end-of-block partials where those are larger."""
    if _build.check_precision(tier, "K7") == "f32":
        return head_smem_bytes(lf, h, 1)
    one, two = _ngp_fit_bf16_layout(lf, h, 1), _ngp_fit_bf16_layout(lf, h, 2)
    return two if two <= _SMEM_2BLK or (one > _SMEM_2BLK and two + SMEM_STATIC <= SMEM_LIMIT) else one


#: The most dynamic shared memory a block may take with two blocks an SM
#: (csrc/ngp_mma.cuh SMEM_2BLK).
_SMEM_2BLK = 115712 - SMEM_STATIC


def _ngp_fit_bf16_layout(lf: int, h: int, ndz: int) -> int:
    nkc, nmt = (lf + 15) // 16, (h + 15) // 16
    lfp, hp, es = 16 * nkc, 16 * nmt, _THREADS + 8
    splits = 1 if nmt > 4 else 2 if nmt > 2 else 4 if nmt == 2 else 8
    gy = nmt * 256 + hp * 4 + nmt * nkc * 512 + nmt * 2 * nkc * 256 + 2 * 8 * 2 * 4
    rows = gy + 2 * _THREADS * 16 + 3 * lfp * es * 2 + ndz * hp * es * 2
    return max(rows, gy + splits * hp * (5 + lfp) * 4)


def ngp_fit_fits(lf: int, h: int, tier: str = "f32") -> bool:
    """LF <= 64, H <= 256 and the head core's shared memory fits a block
    (LF = 16, H = 64 take 98 KB): H <= 204 / 196 / 180 / 116 at LF = 1 / 8 /
    16 / 64. The tiers ("f32", "bf16", or a precision name of TIERS["K7"])
    share that gate; the bf16 kernel's own layout fits wherever it holds
    (tests/test_torch_bf16_walks.py)."""
    arith = _build.check_precision(tier, "K7")
    return (1 <= lf <= MAX_LF and 1 <= h <= MAX_H and head_smem_bytes(lf, h, 1) + SMEM_STATIC <= SMEM_LIMIT
            and ngp_fit_smem_bytes(lf, h, arith) + SMEM_STATIC <= SMEM_LIMIT)


def pack_target(g: GridSpec, sigma, u) -> torch.Tensor:
    """The kernels' target operand [nz, 4, ny*nx] from the standard field
    layouts (sigma [nz, ny, nx], u [3, nz, ny, nx]): a reshape and a
    transpose, on the inputs' device."""
    m = g.ny * g.nx
    s = torch.as_tensor(sigma, dtype=torch.float32).reshape(g.nz, 1, m)
    uu = torch.as_tensor(u, dtype=torch.float32).reshape(3, g.nz, m).movedim(0, 1)
    return torch.cat([s, uu.to(s.device)], dim=1).contiguous()


def _data_partials(y, target):
    """Per-plane raw partials [2, nz] of the squared error: y [nz, 4, ny, nx]
    against the packed target [nz, 4, ny*nx]."""
    e = y.reshape(target.shape) - target
    return torch.stack([torch.sum(e[:, 0] * e[:, 0], dim=-1), torch.sum(e[:, 1:] * e[:, 1:], dim=(1, 2))])


def _check_target(g: GridSpec, target) -> None:
    _build.check_shape(target, (g.nz, 4, g.ny * g.nx), "target")


# ---------------------------------------------------------------------------
# K6: the coordinate MLP's tables
# ---------------------------------------------------------------------------


def _table_outputs(ab, cd, w2t, b2, masks=None, tier="f32"):
    """y = W2T relu(AB + CD[z]) + b2 -> [nz, 4, ny, nx], layer 2 in the
    arithmetic of `tier` ("f32" or "bf16"); with `masks`, the ReLU is the
    given mask times the pre-activation."""
    pre = ab[None] + cd[:, :, 0, None, None]  # [nz, H, ny, nx]
    a1 = torch.clamp_min(pre, 0.0) if masks is None else pre * masks
    y = torch.einsum("oh,zhyx->zoyx", w2t, a1) if tier == "f32" else layer2(a1, w2t, tier, 1)
    return y + b2[None, :, None, None]


def _table_autograd(g, w, outputs_fn, tables, target):
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in tables]
        ls, lu = ops_loss.sum_partials(g, w, _data_partials(outputs_fn(*xs), target.to(xs[0].dtype)))
        grads = torch.autograd.grad(ls + lu, xs)
    return torch.stack([ls, lu]).detach().float(), tuple(x.float() for x in grads)


def fit_table_loss_and_grad_plain(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, tier: str = "f32"):
    """The plain version of K6: (loss [2], (dAB, dCD, dW2T, db2)) by float32
    autograd through the table MLP (layer 2 in the arithmetic of `tier`:
    the bf16 tier rounds the operands of dW2T and da1 too) and the
    fixed-order data loss."""
    return _table_autograd(g, w, lambda *xs: _table_outputs(*xs, tier=tier), (ab, cd, w2t, b2), target)


def fit_table_loss_and_grad_ref(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, tier: str = "f32"):
    """The referee K6 is held to in f32: the float32 forward's outputs and
    ReLU masks, the error, the loss and every derivative in float64; the
    results rounded to float32. (The bf16 tier is held to its plain
    version.)"""
    if tier != "f32":
        raise ValueError("the float64 referee holds the f32 tier; the bf16 tier's is its plain version")
    with torch.no_grad():
        masks = (ab[None] + cd[:, :, 0, None, None]) > 0
        y32 = _table_outputs(ab, cd, w2t, b2)

    def outputs(*xs):
        return _with_value(_table_outputs(*xs, masks=masks), y32)

    return _table_autograd(g, w, outputs, [x.double() for x in (ab, cd, w2t, b2)], target)


def fit_table_loss_and_grad(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, tier: str = "f32"):
    """(loss [2], (dAB [H, ny, nx], dCD [nz, H, 1], dW2T [4, H], db2 [4]))
    from the one-slice tables and the packed target: the kernel of `tier`
    ("f32" or "bf16") for CUDA tensors, the plain version for CPU
    tensors."""
    if not _build.uses_kernel(ab, cd, w2t, b2, target):
        return fit_table_loss_and_grad_plain(g, w, ab, cd, w2t, b2, target, tier)
    _, loss, grads = _launch_fit(g, g, w, ab, cd, w2t, b2, target, tier, "fit" if tier == "f32" else "fit bf16")
    return loss, grads


def _launch_fit(g: GridSpec, g_run: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, tier: str, counter: str):
    """One launch of K6 over the rows of g_run (g itself, or a shard's rows:
    g with nz = nz_local, its CD rows and target rows sliced), scaled by g's
    N: (plane partials [2, g_run.nz], the loss [2] (g's only when g_run is
    g), (dAB, dCD, dW2T, db2))."""
    h, dev = ab.shape[0], ab.device
    g_scale, g = g, g_run
    _build.check_shape(ab, (h, g.ny, g.nx), "AB")
    _build.check_shape(cd, (g.nz, h, 1), "CD")
    _build.check_shape(w2t, (4, h), "W2T")
    _build.check_shape(b2, (4,), "b2")
    _check_target(g, target)
    if not fit_fits(h, tier):
        static = FIT_SMEM_STATIC if tier == "f32" else FIT_SMEM_STATIC_BF16
        raise ValueError(
            f"H={h} needs {fit_smem_bytes(h, tier) + static} B of shared memory a block; K6 ({tier}) fits up "
            f"to {SMEM_LIMIT} B (H <= {_build.gate_top(lambda x: fit_fits(x, tier))})"
        )
    nblk, ntiles = num_blocks(g), num_tiles(g)
    nz, ny, nx = g.shape

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tile_parts = empty(2, nz, ntiles)
    dab_part, dcd_part = empty(dab_slots(g), h, _THREADS), empty(nz, ntiles, h)
    dw2_part, db2_part = empty(nblk, 4, h), empty(nblk, 4)
    dab, dcd, dw2t, db2 = empty(h, ny, nx), empty(nz, h, 1), empty(4, h), empty(4)
    fn = _build.lib().pat_fit if tier == "f32" else _build.lib().pat_fit_bf16
    with torch.cuda.device(dev):
        err = fn(
            *[x.data_ptr() for x in (ab, cd, w2t, b2, target, tile_parts, dab_part, dcd_part, dw2_part,
                                     db2_part, dab, dcd, dw2t, db2)],
            nx, ny, nz, h, nblk,
            *[float(s) for s in ops_loss.loss_scales_f32(g_scale, w)],
            _build.stream_ptr(dev),
        )
    _build.check(err, f"fit kernel ({tier})", "K6", (tile_parts, dab, dcd, dw2t, db2))
    _build.LAUNCHES[counter] += 1
    parts, loss = finalize_partials(g, w, tile_parts)
    return parts, loss, (dab, dcd, dw2t, db2)


def _shard_grid(g: GridSpec, z0: int, nz_local: int) -> GridSpec:
    check_shard(g, z0, nz_local)
    return dataclasses.replace(g, nz=nz_local)


def _scaled_data_loss(g: GridSpec, w: PhysWeights, parts):
    """w_sigma / N sum(parts[0]) + w_u / N sum(parts[1]) with the global N:
    a shard's part of the data loss, for autograd."""
    inv_n = float(ops_loss.inv_n_f32(g))
    return float(np.float32(w.w_sigma)) * inv_n * parts[0].sum() + float(np.float32(w.w_u)) * inv_n * parts[1].sum()


def fit_table_loss_and_grad_shard_plain(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, z0: int,
                                        nz_local: int, tier: str = "f32"):
    """The plain version of K6 on a shard's rows: (raw plane partials
    [2, nz_local], (dAB, dCD [nz_local, H, 1], dW2T, db2)), the owned rows'
    part of the gradient, by float32 autograd through the table MLP on the
    rows [z0, z0 + nz_local) of CD against the shard's target rows
    [nz_local, 4, ny*nx] (the data loss has no stencil, so no halo)."""
    _build.check_shape(target, (_shard_grid(g, z0, nz_local).nz, 4, g.ny * g.nx), "target")
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (ab, cd[z0 : z0 + nz_local], w2t, b2)]
        parts = _data_partials(_table_outputs(*xs, tier=tier), target)
        grads = torch.autograd.grad(_scaled_data_loss(g, w, parts), xs)
    return parts.detach(), grads


def fit_table_loss_and_grad_shard(g: GridSpec, w: PhysWeights, ab, cd, w2t, b2, target, z0: int, nz_local: int,
                                  tier: str = "f32"):
    """K6 launched on a shard's rows (CD [nz, H, 1] sliced to [z0, z0 +
    nz_local), the shard's target rows [nz_local, 4, ny*nx], the gradient
    scales of the global grid) for CUDA tensors, its plain version for CPU
    tensors: (raw plane partials [2, nz_local], (dAB, dCD [nz_local, H, 1],
    dW2T, db2)). The kernel is K6 itself: it indexes the target and the
    partials by row within its launch, so the sliced rows are read where
    they lie."""
    g_own = _shard_grid(g, z0, nz_local)
    if not _build.uses_kernel(ab, cd, w2t, b2, target):
        return fit_table_loss_and_grad_shard_plain(g, w, ab, cd, w2t, b2, target, z0, nz_local, tier)
    counter = "fit shard" if tier == "f32" else "fit bf16 shard"
    parts, _, grads = _launch_fit(g, g_own, w, ab, cd[z0 : z0 + nz_local].contiguous(), w2t, b2, target, tier,
                                  counter)
    return parts, grads


def _loss_and_grad(g, cfg, params, target, t, w, precision, table_fn):
    tier = _build.check_precision(precision, "K6")
    check_dims(cfg, params)
    dev = params["W1"].device
    with torch.enable_grad():
        p = [params[k].detach().requires_grad_() for k in _PARAM_KEYS]
        tt = _t_value(t, dev).requires_grad_()
        tables = fold_tables(g, cfg, dict(zip(_PARAM_KEYS, p)), tt.reshape(1))
    loss, d_tables = table_fn(g, w, *(x.detach() for x in tables), target, tier)
    grads = torch.autograd.grad(tables, p + [tt], d_tables)
    return loss[0] + loss[1], (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])


def fit_loss_and_grad(
    g: GridSpec,
    cfg: MLPGridConfig,
    params: dict,
    target_packed: torch.Tensor,
    t,
    w: PhysWeights = PhysWeights(),
    precision: str = "f32",
):
    """(loss, (grad_params, grad_t)) of the weighted data MSE of the
    coordinate MLP at time t against one packed target ([nz, 4, ny*nx],
    pack_target) from ONE call of K6 (CUDA params) or its plain version
    (CPU params). The gradients are those of train.fit_field.data_loss."""
    return _loss_and_grad(g, cfg, params, target_packed, t, w, precision, fit_table_loss_and_grad)


def fit_loss_and_grad_ref(
    g: GridSpec, cfg: MLPGridConfig, params: dict, target_packed, t, w: PhysWeights = PhysWeights(),
    precision: str = "f32",
):
    """fit_loss_and_grad with the referee (fit_table_loss_and_grad_ref) in
    the kernel's place, on any device."""
    return _loss_and_grad(g, cfg, params, target_packed, t, w, precision, fit_table_loss_and_grad_ref)


# ---------------------------------------------------------------------------
# K7: the encoded field's head
# ---------------------------------------------------------------------------


def _head_outputs(enc, w1, b1, w2, b2, t, masks=None):
    """y = W2^T relu(W1[:-1]^T enc + b1 + W1[-1] t) + b2 -> [nz, 4, ny, nx]."""
    pre = torch.einsum("zcyx,ch->zyxh", enc, w1[:-1]) + (b1 + w1[-1] * t)
    a1 = torch.clamp_min(pre, 0.0) if masks is None else pre * masks
    return torch.movedim(torch.matmul(a1, w2) + b2, -1, 1)


def _head_autograd(g, w, outputs_fn, inputs, t, target, need_denc):
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        y = outputs_fn(*xs, t.to(xs[0].dtype))
        ls, lu = ops_loss.sum_partials(g, w, _data_partials(y, target.to(xs[0].dtype)))
        grads = torch.autograd.grad(ls + lu, xs if need_denc else xs[1:])
    if not need_denc:
        grads = (None, *grads)
    return torch.stack([ls, lu]).detach().float(), tuple(None if x is None else x.float() for x in grads)


def _head_bf16_plain(g, w, enc, w1, b1, w2, b2, t, target, need_denc):
    """K7's bf16 tier written out: base = bf16(enc) bf16(W1c), a1 =
    relu(base + tb1) in float32, y = bf16(a1) bf16(W2) + b2; the error
    cotangent gy by float32 autograd of the data loss; the backward by
    head_backward_plain."""
    with torch.no_grad():
        base = torch.einsum("zcyx,ch->zyxh", _bf16(enc), _bf16(w1[:-1]))
        a1 = torch.clamp_min(base + (b1 + w1[-1] * t), 0.0)
        del base
        y = torch.movedim(torch.matmul(_bf16(a1), _bf16(w2)) + b2, -1, 1)
    with torch.enable_grad():
        yv = y.requires_grad_()
        ls, lu = ops_loss.sum_partials(g, w, _data_partials(yv, target))
        (gy,) = torch.autograd.grad(ls + lu, yv)
    denc, dw1c, db1, _, dw2, db2 = head_backward_plain(
        enc, w1[:-1], [a1], [torch.movedim(gy, 1, -1)], t.reshape(1), w2, "bf16"
    )
    grads = (denc if need_denc else None, torch.cat([dw1c, (t * db1)[None]]), db1, dw2, db2)
    return torch.stack([ls, lu]).detach(), grads


def ngp_fit_head_loss_and_grad_plain(
    g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, tier: str = "f32", need_denc: bool = True
):
    """The plain version of K7: (loss [2], (dEnc or None, dW1 [LF+1, H],
    db1, dW2 [H, 4], db2)); "f32" by float32 autograd through the head and
    the fixed-order data loss, "bf16" by _head_bf16_plain."""
    if tier == "bf16":
        return _head_bf16_plain(g, w, enc, w1, b1, w2, b2, t, target, need_denc)
    return _head_autograd(g, w, _head_outputs, (enc, w1, b1, w2, b2), t, target, need_denc)


def ngp_fit_head_loss_and_grad_ref(
    g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, tier: str = "f32", need_denc: bool = True
):
    """The referee K7 is held to: the float32 forward's outputs and ReLU
    masks, the error, the loss and every derivative in float64; the results
    rounded to float32."""
    _f32_only(tier)
    with torch.no_grad():
        pre = torch.einsum("zcyx,ch->zyxh", enc, w1[:-1]) + (b1 + w1[-1] * t)
        masks = pre > 0
        del pre
        y32 = _head_outputs(enc, w1, b1, w2, b2, t)

    def outputs(*xs):
        return _with_value(_head_outputs(*xs, masks=masks), y32)

    return _head_autograd(g, w, outputs, [x.double() for x in (enc, w1, b1, w2, b2)], t, target, need_denc)


def ngp_fit_head_loss_and_grad(
    g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, tier: str = "f32", need_denc: bool = True
):
    """(loss [2], (dEnc or None, dW1 [LF+1, H], db1 [H], dW2 [H, 4],
    db2 [4])) from the encoding [nz, LF, ny, nx], the head, the time t (a
    0-d float32 tensor) and the packed target, in the arithmetic `tier`
    ("f32" or "bf16"): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if tier not in ("f32", "bf16"):
        raise ValueError(f"K7 runs the arithmetic 'f32' or 'bf16', not {tier!r}")
    if not _build.uses_kernel(enc, w1, b1, w2, b2, t, target):
        return ngp_fit_head_loss_and_grad_plain(g, w, enc, w1, b1, w2, b2, t, target, tier, need_denc)
    counter = "fit_ngp" if tier == "f32" else "fit_ngp bf16"
    _, loss, grads = _launch_ngp_fit(g, g, w, enc, w1, b1, w2, b2, t, target, tier, need_denc, counter)
    return loss, grads


def _launch_ngp_fit(g: GridSpec, g_run: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, tier: str,
                    need_denc: bool, counter: str):
    """One launch of K7 over the rows of g_run (g itself, or a shard's rows:
    its encoding and target rows), scaled by g's N: (plane partials
    [2, g_run.nz], the loss [2] (g's only when g_run is g), (dEnc or None,
    dW1, db1, dW2, db2))."""
    g_scale, g = g, g_run
    lf, h = w1.shape[0] - 1, w1.shape[1]
    _build.check_shape(enc, (g.nz, lf, g.ny, g.nx), "enc")
    _build.check_shape(b1, (h,), "b1")
    _build.check_shape(w2, (h, 4), "W2")
    _build.check_shape(b2, (4,), "b2")
    _build.check_shape(t, (), "t")
    _check_target(g, target)
    if not ngp_fit_fits(lf, h, tier):
        top = _build.gate_top(lambda x: ngp_fit_fits(lf, x, tier)) if lf <= MAX_LF else 0
        raise ValueError(
            f"LF={lf}, H={h}: K7 ({tier}) takes LF <= {MAX_LF}, H <= {top} at this LF ({SMEM_LIMIT} B of "
            f"shared memory a block; this needs {ngp_fit_smem_bytes(lf, h, tier)} B)"
        )
    nblk = num_blocks(g)
    dev = enc.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tb1 = (b1 + w1[-1] * t).contiguous()
    tile_parts = empty(2, g.nz, num_tiles(g))
    dw1_part, head_part, db2_part = empty(nblk, lf, h), empty(nblk, h, 5), empty(nblk, 4)
    denc = empty(g.nz, lf, g.ny, g.nx) if need_denc else None
    dw1c, dhead, db2 = empty(lf, h), empty(h, 5), empty(4)
    # W1[:-1] is the leading LF rows of the contiguous W1
    ptrs = (enc, w1, tb1, w2, b2, target, tile_parts, dw1_part, head_part, db2_part, denc, dw1c, dhead, db2)
    with torch.cuda.device(dev):
        err = _build.lib().pat_ngp_fit(
            *[x.data_ptr() if x is not None else None for x in ptrs],
            g.nx, g.ny, g.nz, lf, h, nblk,
            *[float(s) for s in ops_loss.loss_scales_f32(g_scale, w)],
            _build.NGP_TIER_CODES[tier], _build.stream_ptr(dev),
        )
    _build.check(err, "NGP fit kernel", "K7", (tile_parts, denc, dw1c, dhead, db2))
    _build.LAUNCHES[counter] += 1
    parts, loss = finalize_partials(g, w, tile_parts)
    db1 = dhead[:, 0]
    dw1 = torch.cat([dw1c, (t * db1)[None]])
    return parts, loss, (denc, dw1, db1, dhead[:, 1:], db2)


def ngp_fit_head_loss_and_grad_shard_plain(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, z0: int,
                                           nz_local: int, tier: str = "f32", need_denc: bool = True):
    """The plain version of K7 on a shard's rows: (raw plane partials
    [2, nz_local], (dEnc [nz_local, LF, ny, nx] or None, dW1, db1, dW2,
    db2)) from the shard's encoding rows enc [nz_local, LF, ny, nx] and
    target rows, scaled by the global N: float32 autograd through the head
    ("f32"), or the bf16 tier written out (head_backward_plain)."""
    g_own = _shard_grid(g, z0, nz_local)
    _build.check_shape(enc, (g_own.nz,) + enc.shape[1:], "enc")
    if tier == "bf16":
        return _head_bf16_plain_scaled(g, g_own, w, enc, w1, b1, w2, b2, t, target, need_denc)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (enc, w1, b1, w2, b2)]
        parts = _data_partials(_head_outputs(*xs, t.to(xs[0].dtype)), target)
        grads = torch.autograd.grad(_scaled_data_loss(g, w, parts), xs if need_denc else xs[1:])
    if not need_denc:
        grads = (None, *grads)
    return parts.detach(), tuple(grads)


def _head_bf16_plain_scaled(g, g_own, w, enc, w1, b1, w2, b2, t, target, need_denc):
    """_head_bf16_plain on a shard's rows with the global N."""
    with torch.no_grad():
        base = torch.einsum("zcyx,ch->zyxh", _bf16(enc), _bf16(w1[:-1]))
        a1 = torch.clamp_min(base + (b1 + w1[-1] * t), 0.0)
        del base
        y = torch.movedim(torch.matmul(_bf16(a1), _bf16(w2)) + b2, -1, 1)
    with torch.enable_grad():
        yv = y.requires_grad_()
        parts = _data_partials(yv, target)
        (gy,) = torch.autograd.grad(_scaled_data_loss(g, w, parts), yv)
    denc, dw1c, db1, _, dw2, db2 = head_backward_plain(
        enc, w1[:-1], [a1], [torch.movedim(gy, 1, -1)], t.reshape(1), w2, "bf16"
    )
    grads = (denc if need_denc else None, torch.cat([dw1c, (t * db1)[None]]), db1, dw2, db2)
    return parts.detach(), grads


def ngp_fit_head_loss_and_grad_shard(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, t, target, z0: int,
                                     nz_local: int, tier: str = "f32", need_denc: bool = True):
    """K7 launched on a shard's rows (its encoding rows [nz_local, LF, ny,
    nx] and target rows, the gradient scales of the global grid) for CUDA
    tensors, its plain version for CPU tensors: (raw plane partials
    [2, nz_local], (dEnc of the owned rows or None, dW1, db1, dW2, db2))."""
    g_own = _shard_grid(g, z0, nz_local)
    if tier not in ("f32", "bf16"):
        raise ValueError(f"K7 runs the arithmetic 'f32' or 'bf16', not {tier!r}")
    if not _build.uses_kernel(enc, w1, b1, w2, b2, t, target):
        return ngp_fit_head_loss_and_grad_shard_plain(g, w, enc, w1, b1, w2, b2, t, target, z0, nz_local, tier,
                                                      need_denc)
    counter = "fit_ngp shard" if tier == "f32" else "fit_ngp bf16 shard"
    parts, _, grads = _launch_ngp_fit(g, g_own, w, enc, w1, b1, w2, b2, t, target, tier, need_denc, counter)
    return parts, grads


def _ngp_loss_and_grad(g, ncfg, params, target, t, w, precision, head_fn):
    tier = ngp_mod.check_precision(precision, "K7")
    if ncfg.out != 4:
        raise ValueError("the NGP fit kernel's head has the 4 physics channels")
    tables = params["tables"]
    has_enc = any(x.numel() > 0 for x in tree.leaves(tables))
    w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
    tt = _t_value(t, w1.device)
    tab = tree.map_tree(lambda x: x.detach().requires_grad_(has_enc), tables)
    with torch.enable_grad():
        # the bf16 tier reads the fast encode (pallas/fit.py:643)
        enc = encoders.encode_grid_zcf(ncfg.encoding, tab, g, fast=tier == "bf16")
    loss, (denc, dw1, db1, dw2, db2) = head_fn(
        g, w, enc.detach().contiguous(), w1, b1, w2, b2, tt, target, tier, need_denc=has_enc
    )
    if has_enc:
        leaves = tree.leaves(tab)
        with annotate("pat.encode.pullback"):
            d_leaves = torch.autograd.grad(enc, leaves, denc, allow_unused=True)
        d_tables = tree.unflatten(tables, _zeros_for_unused(d_leaves, leaves))
    else:
        d_tables = tree.map_tree(torch.zeros_like, tables)
    gp = {"tables": d_tables, "W1": dw1, "b1": db1, "W2": dw2, "b2": db2}
    return loss[0] + loss[1], (gp, torch.sum(w1[-1] * db1))


def ngp_fit_loss_and_grad(
    g: GridSpec, ncfg, params: dict, target_packed: torch.Tensor, t, w: PhysWeights = PhysWeights(),
    precision: str = "f32",
):
    """(loss, (grad_params, grad_t)) of the weighted data MSE of an
    encoded-field model (hash, Fourier or a registered family) at time t
    against one packed target, from ONE call of K7 (CUDA params) or its
    plain version (CPU params), plus the encoder's pull-back. The gradients
    are those of train.fit_field.data_loss, as a tree shaped like `params`."""
    return _ngp_loss_and_grad(g, ncfg, params, target_packed, t, w, precision, ngp_fit_head_loss_and_grad)


def ngp_fit_loss_and_grad_ref(
    g: GridSpec, ncfg, params: dict, target_packed, t, w: PhysWeights = PhysWeights(), precision: str = "f32"
):
    """ngp_fit_loss_and_grad with the referee head in the kernel's place: the
    same encoder pull-back, on any device."""
    return _ngp_loss_and_grad(g, ncfg, params, target_packed, t, w, precision, ngp_fit_head_loss_and_grad_ref)


# ---------------------------------------------------------------------------
# The sharded fit: K6 / K7 on each rank's rows
# ---------------------------------------------------------------------------


def fit_loss_and_grad_sharded(g: GridSpec, cfg: MLPGridConfig, mesh, w: PhysWeights = PhysWeights(),
                              precision: str = "f32"):
    """Returns fn(params, target_local, t) -> (loss, (grad_params, grad_t))
    over the z mesh (parallel/mesh.ZMesh; JAX pallas/fit.py:297): each rank
    runs K6 (its plain version for CPU params) on its own rows, the target
    its rows of the packed target (parallel.mesh.shard_rows of pack_target's
    output) and CD sliced to them; no halo (the data loss has no stencil).
    The table-gradient partials are all-reduced, the rows' dCD all-gathered
    and the loss chained from the gathered plane partials in global z
    order."""
    tier = _build.check_precision(precision, "K6")
    z0, nz_local = mesh.rows(g.nz)

    def loss_and_grad(params, target_local, t):
        check_dims(cfg, params)
        p = [params[k].detach().requires_grad_() for k in _PARAM_KEYS]
        tt = _t_value(t, p[0].device).requires_grad_()
        with torch.enable_grad():
            tables = fold_tables(g, cfg, dict(zip(_PARAM_KEYS, p)), tt.reshape(1))
        parts, (dab, dcd, dw2t, db2) = fit_table_loss_and_grad_shard(
            g, w, *(x.detach() for x in tables), target_local, z0, nz_local, tier
        )
        loss = sum_plane_partials(g, w, mesh.all_gather(parts, 1))
        d_tables = (mesh.all_reduce(dab), mesh.all_gather(dcd, 0), mesh.all_reduce(dw2t), mesh.all_reduce(db2))
        grads = torch.autograd.grad(tables, p + [tt], d_tables)
        return loss[0] + loss[1], (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])

    return loss_and_grad


def ngp_fit_loss_and_grad_sharded(g: GridSpec, ncfg, mesh, w: PhysWeights = PhysWeights(), precision: str = "f32"):
    """Returns fn(params, target_local, t) -> (loss, (grad_params, grad_t))
    over the z mesh (JAX pallas/fit.py:689): each rank encodes exactly its
    own rows (encoders.encode_grid_zcf_rows; no halo) and runs K7 (its plain
    version for CPU params) against its target rows; its dEnc pulls back
    through the shard-local encoder, and the table and head gradients are
    all-reduced; the loss is chained from the gathered plane partials in
    global z order. Nothing grid-sized is gathered."""
    tier = ngp_mod.check_precision(precision, "K7")
    z0, nz_local = mesh.rows(g.nz)
    if ncfg.out != 4:
        raise ValueError("the NGP fit kernel's head has the 4 physics channels")

    def loss_and_grad(params, target_local, t):
        tables = params["tables"]
        has_enc = any(x.numel() > 0 for x in tree.leaves(tables))
        w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
        tt = _t_value(t, w1.device)
        tab = tree.map_tree(lambda x: x.detach().requires_grad_(has_enc), tables)
        rows = torch.arange(z0, z0 + nz_local)  # host rows: the encoder reads them on the host
        with torch.enable_grad():
            enc = encoders.encode_grid_zcf_rows(ncfg.encoding, tab, g, rows, fast=tier == "bf16")
        parts, (denc, dw1, db1, dw2, db2) = ngp_fit_head_loss_and_grad_shard(
            g, w, enc.detach().contiguous(), w1, b1, w2, b2, tt, target_local, z0, nz_local, tier, need_denc=has_enc
        )
        loss = sum_plane_partials(g, w, mesh.all_gather(parts, 1))
        if has_enc:
            leaves = tree.leaves(tab)
            d_leaves = _zeros_for_unused(torch.autograd.grad(enc, leaves, denc, allow_unused=True), leaves)
            d_tables = tree.unflatten(tables, [mesh.all_reduce(x) for x in d_leaves])
        else:
            d_tables = tree.map_tree(torch.zeros_like, tables)
        dw1, db1, dw2, db2 = (mesh.all_reduce(x) for x in (dw1, db1, dw2, db2))
        gp = {"tables": d_tables, "W1": dw1, "b1": db1, "W2": dw2, "b2": db2}
        return loss[0] + loss[1], (gp, torch.sum(w1[-1] * db1))

    return loss_and_grad
