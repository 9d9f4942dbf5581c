"""K5: the NGP backward mega-kernel (port of phys_autodiff_tpu/pallas/mega_ngp.py;
CUDA source csrc/mega_ngp.cu).

`ngp_loss_and_grad` returns the loss AND the gradients of the encoded-field
params and of t from one kernel call. The wrapper encodes the grid
(models/encoders.encode_grid_zcf, [nz, LF, ny, nx]) and hands the head to
`head_loss_and_grad`, which gives the loss and, as the JAX kernel does, the
gradients of (enc, W1, b1, W2, b2): W1's last row and b1 come out of the
kernel whole (dtw1 = sum_s t_s sum dz1_s, db1 = sum_s sum dz1_s), so the
nearly cancelling t -+ dt legs are never added outside it. Autograd pulls
dEnc back to the tables (the transposed resampling matmuls and the corner
gather-sum of the encoder: no atomics, the same bits every run), as the
JAX package pulls it back with jax.vjp, and d_t = W1[-1] . db1
(mega_ngp.py:575-632). A parameter-free encoding
(Fourier) skips the dEnc output and its pull-back; its empty tables get a
zero gradient.

For CPU tensors `head_loss_and_grad` runs its plain version (float32
autograd through the head, the staged residuals, the plane partials and
their fixed-order sum); for CUDA tensors it launches the kernel or raises.
`ngp_loss_and_grad_plain` is autograd through the whole staged pipeline
(ngp.generate_fields -> ops.total_loss), on any device.
`head_loss_and_grad_ref` / `ngp_loss_and_grad_ref` are the referee the
kernel is held to on the card: the float32 forward's fields and ReLU
masks, the backward in float64.

Gates, re-decided for the card: every central or upwind grid, periodic or
clamp, of any extent (`ngp_supported`); the head core (csrc/ngp_head.cuh)
takes LF <= 64 and H <= 256 and holds a tile row's encoding and dz1 in a
block's shared memory, which bounds LF x H further (`ngp_fits`); the bf16
tier's own kernels take less shared memory wherever that gate admits a
shape (`bf16_smem_bytes`). A shape outside the gates raises; there is no
other path for CUDA tensors.

A time-aware encoding (K-Planes, models/kplanes.py) gives each slice its
own encoding, enc_s [3, nz, LF, ny, nx], and the head no time input:
`slices_head_loss_and_grad` (csrc/mega_ngp.cu pat_mega_ngp_kplanes, one
entry a step, LF <= 128 and H <= 64 in f32) gives the loss, a dEnc for each
slice and dW1 = sum_s enc_s^T dz1_s, db1, dW2, db2; its plain version is
float32 autograd through the per-slice head (the FFMA chain's z1, as the
kernels form it) and its referee the float64 head on the float32 forward's
values. The wrapper then pulls the three dEnc back through the encoder.
The bf16 and f32_fastbwd tiers, K7 and the sharded step take no
time-aware encoding and raise.

The shard-local build (`head_loss_and_grad_shard`; JAX
`_build_ngp_bwd_call(nz_local=...)`, pallas/mega_ngp.py:167-190) runs the
kernel on a shard's rows from a pre-extended encoding of nz_local + 4 rows
(mega_bwd.halo_rows); its dEnc covers the owned rows. Its plain version
and the float64 referee (`head_loss_and_grad_shard_ref`) recompute the
halo themselves; `ngp_loss_and_grad_sharded` runs it a rank, on the
shard-local encoder (encoders.encode_grid_zcf_rows).

Tiers (kernels/_build.TIERS["K5"]): "f32" (and "f32_high", "bf16x3": the
same arithmetic, as in the JAX package); "bf16" rounds the operands of
every head product to bf16 and sums in float32 (pallas/mega_ngp.py:
280-446: base = bf16(enc) bf16(W1c), y_s = bf16(a1_s) bf16(W2) + b2,
da1_s = bf16(W2) bf16(gy_s), dW2 += bf16(gy_s)^T bf16(a1_s), dW1 +=
bf16(enc)^T bf16(dz1_sum), dEnc = bf16(dz1_sum) bf16(W1c)^T; the masks,
db1, dtw1 and dz1_sum from float32 values), on the fast encode
(models/encoders.encode_grid_zcf(fast=True)); "f32_fastbwd" is the f32
forward and loss (to the bit) with a backward that rounds the recomputed
base before the masks and a1, and the encoding of dW1, to bf16
(:136-157, :211-219). Their plain versions write the head's backward out
with those rounding points (`head_backward_plain`); the residuals, the
loss and the stencil adjoint stay float32, as K1's body is. The plain
head's products and its sums over cells run in float64 and are rounded
once (`_mm64`), but for the float32 base, the f32 kernels' FMA chain
(`_fma_chain`); so the plain versions give the same bits for any number
of rows (a shard's or the whole grid's) on any machine. On the card the
bf16 tier runs every product of the head on the tensor cores (mma.sync,
csrc/mega_ngp.cu namespace bfk: layer 2, da1 and dW2 included, the head's
elementwise work on the fragments in registers, a pipelined row walk);
f32_fastbwd runs the f32 kernel's FFMA chains with the roundings, and its
dW1 on the tensor cores as exact bf16 splits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega_bwd import HALO, check_shard, halo_rows, owned_cotangent_plain
from phys_autodiff_tpu_torch.kernels.mlp import _bf16
from phys_autodiff_tpu_torch.kernels.residuals import (
    TILE_X, TILE_Y, finalize_partials, num_tiles, sum_plane_partials,
)
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.config import GridSpec, PhysWeights
from phys_autodiff_tpu_torch.utils.timing import annotate

_THREADS = TILE_X * TILE_Y
#: The widest encoding and hidden layer the head core takes (csrc/ngp_head.cuh).
MAX_LF = 64
MAX_H = 256
#: Shared memory a block may use on an H100 (bytes), and what the head
#: kernels take of it statically (their block-sum scratch).
SMEM_LIMIT = 232448
SMEM_STATIC = 64
def _stride(n4: int) -> int:
    return n4 + 4 if n4 % 8 == 0 else n4


def head_smem_bytes(lf: int, h: int, ngy: int) -> int:
    """Dynamic shared memory of a head-core kernel (csrc/ngp_head.cuh
    layout) with `ngy` float4 of cotangents a cell: W1c, W2 and the biases
    (padded to multiples of 4), gy, the row's encoding and dz1, or the
    end-of-block scratch where that is larger."""
    lfp, hp = (lf + 3) & ~3, (h + 3) & ~3
    enc = lfp * _stride(hp) + 8 * hp + 4 * ngy * _THREADS
    return 4 * (enc + max(_THREADS * (_stride(lfp) + _stride(hp)), 6144))


def smem_bytes(lf: int, h: int) -> int:
    """Dynamic shared memory of K5's adjoint pass (gy: dF and g/(2dt))."""
    return head_smem_bytes(lf, h, 2)


def ngp_supported(g: GridSpec) -> bool:
    """Every central or upwind grid, periodic or clamp, of any extent."""
    return g.scheme in ("central", "upwind")


#: The bf16 row stride of K5 bf16's [channel or hidden unit][cell] tiles.
_BF_ES = _THREADS + 8


def bf16_smem_bytes(lf: int, h: int) -> tuple[int, int]:
    """Dynamic shared memory of K5 bf16's fields pass and, with one dz1_sum
    buffer (its least), its adjoint pass (csrc/mega_ngp.cu bfk::
    fields_layout, adjoint_layout): the fragments of W1c and W2, tb1, two
    encoding rows in bf16, two rows of gy, dz1_sum hidden-major, or the
    splits' end-of-block partials where those are larger."""
    nkc, nmt = (lf + 15) // 16, (h + 15) // 16
    lfp, hp = 16 * nkc, 16 * nmt
    splits = 1 if nmt > 4 else 2 if nmt > 2 else 4 if nmt == 2 else 8
    fields = nkc * 2 * nmt * 256 + nmt * 256 + hp * 16 + 2 * lfp * _BF_ES * 2
    frags = nmt * nkc * 512 + nmt * 2 * nkc * 256
    rows = frags + 2 * _THREADS * 16 + 2 * lfp * _BF_ES * 2 + hp * _BF_ES * 2
    return fields, max(rows, frags + splits * hp * (6 + lfp) * 4)


def ngp_fits(lf: int, h: int, tier: str = "f32") -> bool:
    """LF <= 64, H <= 256 and the f32 adjoint pass's shared memory fits a
    block (LF = 16, H = 64 take 102 KB; at LF = 16 H reaches 180). The
    f32_fastbwd tier has that layout and the bf16 tier takes less
    (bf16_smem_bytes), so every tier ("f32", "bf16", "f32_fastbwd": the
    arithmetic) has this gate. `tier` may also be a precision name
    (TIERS["K5"])."""
    _build.check_precision(tier, "K5")
    return 1 <= lf <= MAX_LF and 1 <= h <= MAX_H and smem_bytes(lf, h) + SMEM_STATIC <= SMEM_LIMIT


def _check_gates(g: GridSpec, lf: int, h: int, tier: str = "f32") -> None:
    if not ngp_supported(g):
        raise ValueError(f"the NGP backward kernel takes central or upwind, not {g.scheme!r}")
    if not ngp_fits(lf, h, tier):
        top = _build.gate_top(lambda x: ngp_fits(lf, x, tier)) if lf <= MAX_LF else 0
        raise ValueError(
            f"LF={lf}, H={h}: the NGP backward kernel ({tier}) takes LF <= {MAX_LF}, H <= {top} at this LF "
            f"({SMEM_LIMIT} B of shared memory a block; this needs {smem_bytes(lf, h)} B)"
        )


# ---------------------------------------------------------------------------
# The head: the kernel, its plain version and the referee
# ---------------------------------------------------------------------------


def first_layer_bias(w1, b1, ts):
    """tb1 = b1 + W1[-1] t_s [H, 3]: the first layer's bias at the slices
    t-dt, t, t+dt (the time input folded in)."""
    return b1[:, None] + w1[-1][:, None] * ts[None, :]


def _rounded(x, on: bool):
    return _bf16(x) if on else x


def _snapshots(ys) -> FieldSnapshots:
    sig = [y[..., 0] for y in ys]
    u = [torch.movedim(y[..., 1:4], -1, 0) for y in ys]
    return FieldSnapshots(sig[0], sig[1], sig[2], u[0], u[1], u[2])


def _mm64(eq: str, *operands):
    """einsum of the operands in float64: the plain head's products. Each
    product of float32 values is exact in float64 and the sums are rounded
    once where the caller casts back, so the result does not depend on how
    many cells the product takes (a shard's rows or the whole grid's) or on
    the order a machine's GEMM kernels sum in."""
    return torch.einsum(eq, *(x.double() for x in operands))


def _head_from_base(base, tb1, w2, b2, masks=None, arithmetic: str = "f32") -> FieldSnapshots:
    bf = arithmetic == "bf16"
    w2d = _rounded(w2, bf).double()  # one node: autograd sums the slices' dW2 in float64
    ys = []
    for s in range(3):
        pre = base + tb1[:, s]
        a1 = torch.clamp_min(pre, 0.0) if masks is None else pre * masks[s]
        ys.append(_mm64("zyxh,ho->zyxo", _rounded(a1, bf), w2d).to(base.dtype) + b2)
    return _snapshots(ys)


def _fma_chain(enc, w1c):
    """sum_c enc[:, c] W1c[c] -> [nz, ny, nx, H] as the kernels' FFMA chain
    forms it (csrc/ngp_head.cuh base_item): one fused multiply-add a
    channel, in channel order from zero. A step's product is exact in
    float64 and the step rounds once to float32: the fused multiply-add,
    but for double rounding where a float64 sum meets a float32 tie (about
    2^-29 of the steps). Elementwise, so of any shape's bits."""
    b = None
    for c in range(enc.shape[1]):
        p = enc[:, c, :, :, None].double() * w1c[c].double()
        b = (p if b is None else p + b.double()).float()
    return b


def _base(enc, w1, arithmetic: str = "f32"):
    """W1[:-1]^T enc per cell -> [nz, ny, nx, H]: _products of W1's channel
    rows."""
    return _products(enc, w1[:-1], arithmetic)


def _products(enc, w1c, arithmetic: str = "f32"):
    """W1c^T enc per cell -> [nz, ny, nx, H] (W1c: the channel rows of W1;
    all of W1 where the head has no time input). "bf16": the rounded
    operands' products summed in float64 and rounded once (_mm64; the
    tensor cores' products are exact). Otherwise, in float32, the value of
    the f32 kernels' FFMA chain (_fma_chain: fastbwd's bf16 rounding of the
    base and the ReLU masks then fall where the kernel's do) with the
    derivatives of the float64 products; in float64 (the referee's
    derivatives) the float64 products."""
    if arithmetic == "bf16":
        return _mm64("zcyx,ch->zyxh", _bf16(enc), _bf16(w1c)).to(enc.dtype)
    if enc.dtype == torch.float64:
        return _mm64("zcyx,ch->zyxh", enc, w1c)
    with torch.no_grad():
        value = _fma_chain(enc, w1c)
    if not (torch.is_grad_enabled() and (enc.requires_grad or w1c.requires_grad)):
        return value
    return _with_value(_mm64("zcyx,ch->zyxh", enc, w1c), value).to(enc.dtype)


def head_fields_plain(enc, w1, b1, w2, b2, ts) -> FieldSnapshots:
    """The fields of the three slices from the encoding [nz, LF, ny, nx]:
    base = W1[:-1]^T enc, y_s = W2^T relu(base + b1 + W1[-1] t_s) + b2."""
    return _head_from_base(_base(enc, w1), first_layer_bias(w1, b1, ts), w2, b2)


def _with_value(x, value):
    """x's derivatives, value's value."""
    return x + (value.to(x.dtype) - x).detach()


def head_fields_ref(enc, w1, b1, w2, b2, ts) -> FieldSnapshots:
    """The referee's fields, float64 from float32 inputs. Their values are
    the float32 forward's (head_fields_plain: the fields, tb1 and ReLU's
    masks as the kernel computes them); their derivatives are the float64
    head's with those masks. The forward's rounding is not the backward's
    to answer for: a float32 field's rounding, 1/(2 dt) times larger in its
    time derivative, reaches every cell's residual and g (about 8e-5 of
    dEnc at 128x96x96 on an H100), the same in any float32 version."""
    with torch.no_grad():
        tb1 = first_layer_bias(w1, b1, ts)
        base = _base(enc, w1)
        masks = [base + tb1[:, s] > 0 for s in range(3)]
        values = _head_from_base(base, tb1, w2, b2)
        del base
    w1d = w1.double()
    tb1d = _with_value(first_layer_bias(w1d, b1.double(), ts.double()), tb1)
    exact = _head_from_base(_base(enc.double(), w1d), tb1d, w2.double(), b2.double(), masks)
    return FieldSnapshots(*(_with_value(e, v) for e, v in zip(exact, values)))


def _head_autograd(g, w, fields_fn, inputs, need_denc):
    """(loss [2], grads of `inputs`) by autograd through fields_fn(*inputs),
    the staged residuals and the plane partials' fixed-order sum; the first
    input's gradient None where not need_denc."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        fields = fields_fn(*xs)
        ls, lu = ops_loss.sum_partials(g, w, ops_loss.plane_partials(*ops_stencil.residuals(g, fields)))
        grads = torch.autograd.grad(ls + lu, xs if need_denc else xs[1:])
    if not need_denc:
        grads = (None, *grads)
    return torch.stack([ls, lu]).detach().float(), tuple(grads)


def head_backward_plain(enc, w1c, a1s, gys, ts, w2, arithmetic: str):
    """The head's backward written out with the rounding points of a tier
    ("bf16" or "f32_fastbwd"), from the slices' activations a1s and field
    cotangents gys ([nz, ny, nx, H] and [nz, ny, nx, 4] each) and their
    times ts: (dEnc [nz, LF, ny, nx], dW1c [LF, H], db1, dtw1 [H], dW2
    [H, 4], db2 [4]). As the JAX kernels' stage 3 (pallas/mega_ngp.py:
    371-446, pallas/fit.py:480-527): bf16 rounds gy, W2 and a1 in the
    products of da1 and dW2, and dz1_sum, enc and W1c in those of dW1 and
    dEnc; fastbwd rounds enc for dW1 alone (its a1s come from the rounded
    base). dz1_sum is the float32 sum of the slices' dz1, as the kernels
    add it. The products (_mm64) and the sums over cells and slices (db1,
    dtw1, dW2, db2) run in float64 and are rounded once, so they do not
    depend on the shape or the machine. Autograd through a cast would pass
    the gradients on unrounded, so this is written out."""
    bf = arithmetic == "bf16"
    w2r = _rounded(w2, bf)
    dz_sum, db1, dtw1, dw2, db2 = None, 0.0, 0.0, 0.0, 0.0
    for s, (a1, gy) in enumerate(zip(a1s, gys)):
        gyr = _rounded(gy, bf)
        dz1 = torch.where(a1 > 0.0, _mm64("zyxo,ho->zyxh", gyr, w2r).float(), 0.0)
        rowsum = dz1.double().sum(dim=(0, 1, 2))
        db1 = db1 + rowsum
        dtw1 = dtw1 + ts[s].double() * rowsum
        dw2 = dw2 + _mm64("zyxh,zyxo->ho", _rounded(a1, bf), gyr)
        db2 = db2 + gy.double().sum(dim=(0, 1, 2))
        dz_sum = dz1 if dz_sum is None else dz_sum + dz1
    dzr = _rounded(dz_sum, bf)
    dw1c = _mm64("zcyx,zyxh->ch", _bf16(enc), dzr).float()
    denc = _mm64("zyxh,ch->zcyx", dzr, _rounded(w1c, bf)).float()
    return denc, dw1c, db1.float(), dtw1.float(), dw2.float(), db2.float()


def _head_tier_plain(g, w, enc, w1, b1, w2, b2, ts, need_denc, arithmetic):
    """head_loss_and_grad_plain of the tiers "bf16" and "f32_fastbwd": the
    forward in the tier's arithmetic, the field cotangents by float32
    autograd of the staged residuals and loss, then head_backward_plain."""
    with torch.no_grad():
        tb1 = first_layer_bias(w1, b1, ts)
        base = _base(enc, w1, arithmetic)
        ys = _head_from_base(base, tb1, w2, b2, arithmetic=arithmetic)
        if arithmetic == "f32_fastbwd":
            base = _bf16(base)
        a1s = [torch.clamp_min(base + tb1[:, s], 0.0) for s in range(3)]
        del base
    ymap = (ys.sigma_tm1, ys.sigma_t, ys.sigma_tp1, ys.u_tm1, ys.u_t, ys.u_tp1)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in ymap]
        ls, lu = ops_loss.sum_partials(g, w, ops_loss.plane_partials(*ops_stencil.residuals(g, FieldSnapshots(*xs))))
        gf = torch.autograd.grad(ls + lu, xs)
    gys = [torch.cat([gf[s][..., None], torch.movedim(gf[3 + s], 0, -1)], dim=-1) for s in range(3)]
    denc, dw1c, db1, dtw1, dw2, db2 = head_backward_plain(enc, w1[:-1], a1s, gys, ts, w2, arithmetic)
    grads = (denc if need_denc else None, torch.cat([dw1c, dtw1[None]]), db1, dw2, db2)
    return torch.stack([ls, lu]).detach(), grads


def head_loss_and_grad_plain(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, tier: str = "f32",
                             need_denc: bool = True):
    """The plain version of the kernel: (loss [2], (dEnc or None, dW1, db1,
    dW2, db2)). tier "f32": float32 autograd through the head, the staged
    residuals, the plane partials and their fixed-order sum; "bf16" and
    "f32_fastbwd": _head_tier_plain."""
    if tier != "f32":
        return _head_tier_plain(g, w, enc, w1, b1, w2, b2, ts, need_denc, tier)
    return _head_autograd(g, w, lambda *xs: head_fields_plain(*xs, ts), (enc, w1, b1, w2, b2), need_denc)


def _f32_only(tier: str) -> None:
    if tier != "f32":
        raise ValueError(f"the float64 referee holds the f32 tier; {tier!r} is held to its plain version")


def head_loss_and_grad_ref(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, tier: str = "f32",
                           need_denc: bool = True):
    """The referee the kernel is held to: autograd as in the plain version,
    on head_fields_ref, the residuals and the loss in float64; the
    gradients rounded to float32. float64, so that the check measures the
    kernel's rounding: the t -+ dt cotangents are 1/(2 dt) times the t
    slice's and nearly cancel, and float32 autograd sums them slice by
    slice (about 1e-4 of dW2 lost at 128x96x96)."""
    _f32_only(tier)
    return _head_autograd(g, w, lambda *xs: head_fields_ref(*xs, ts), (enc, w1, b1, w2, b2), need_denc)


def head_loss_and_grad(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, tier: str = "f32",
                       need_denc: bool = True):
    """(loss [2], (dEnc or None, dW1 [LF+1, H], db1 [H], dW2 [H, 4],
    db2 [4])) from the encoding [nz, LF, ny, nx], the head and the slice
    times ts [3], in the arithmetic `tier` ("f32", "bf16" or
    "f32_fastbwd"): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _build.NGP_TIER_CODES[tier]  # an unknown tier raises KeyError on every device
    if not _build.uses_kernel(enc, w1, b1, w2, b2, ts):
        return head_loss_and_grad_plain(g, w, enc, w1, b1, w2, b2, ts, tier, need_denc)
    counter = "mega_ngp" if tier == "f32" else f"mega_ngp {tier}"
    _, loss, grads = _launch(g, w, enc, w1, b1, w2, b2, ts, tier, need_denc, 0, g.nz, counter)
    return loss, grads


def _launch(g, w, enc, w1, b1, w2, b2, ts, tier, need_denc, z0, nz_local, counter):
    """One launch of the kernel for the rows [z0, z0 + nz_local) of g (the
    whole grid: z0 = 0, nz_local = nz, enc [nz, ...]; a shard: enc of the
    rows mega_bwd.halo_rows gives, [nz_local + 4, ...]): (plane partials
    [2, nz_local], the loss [2] (the whole grid's only), (dEnc [nz_local,
    LF, ny, nx] or None, dW1, db1, dW2, db2)), the owned rows' part of the
    sums."""
    code = _build.NGP_TIER_CODES[tier]
    lf, h = w1.shape[0] - 1, w1.shape[1]
    nb = nz_local if nz_local == g.nz else nz_local + 2 * HALO
    _build.check_shape(enc, (nb, lf, g.ny, g.nx), "enc")
    _build.check_shape(b1, (h,), "b1")
    _build.check_shape(w2, (h, 4), "W2")
    _build.check_shape(b2, (4,), "b2")
    _build.check_shape(ts, (3,), "ts")
    _check_gates(g, lf, h, tier)
    nblk = num_blocks(dataclasses.replace(g, nz=nz_local))
    dev = enc.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tb1 = first_layer_bias(w1, b1, ts).contiguous()
    tile_parts = empty(2, nb, num_tiles(g))
    fbuf, gbuf = empty(12, nb, g.ny, g.nx), empty(4, nb, g.ny, g.nx)
    dw1_part, head_part, db2_part = empty(nblk, lf, h), empty(nblk, h, 6), empty(nblk, 4)
    denc = empty(nz_local, lf, g.ny, g.nx) if need_denc else None
    dw1c, dhead, db2 = empty(lf, h), empty(h, 6), empty(4)
    # W1[:-1] is the leading LF rows of the contiguous W1
    ptrs = (enc, w1, tb1, ts, w2, b2, fbuf, gbuf, tile_parts, dw1_part, head_part, db2_part, denc,
            dw1c, dhead, db2)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_ngp(
            *[x.data_ptr() if x is not None else None for x in ptrs],
            g.nx, g.ny, g.nz, z0, nz_local, lf, h, nblk, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            *[float(s) for s in ops_loss.loss_scales_f32(g, w)],
            code, _build.stream_ptr(dev),
        )
    _build.check(err, "NGP backward mega kernel", "K5", (tile_parts, denc, dw1c, dhead, db2))
    _build.LAUNCHES[counter] += 1
    parts, loss = finalize_partials(dataclasses.replace(g, nz=nb), w, tile_parts)
    dw1 = torch.cat([dw1c, dhead[None, :, 1]])
    hz = (nb - nz_local) // 2
    return parts[:, hz : hz + nz_local], loss, (denc, dw1, dhead[:, 0], dhead[:, 2:], db2)


# ---------------------------------------------------------------------------
# The head on per-slice encodings (a time-aware encoder)
# ---------------------------------------------------------------------------

#: The widest encoding and hidden layer of the per-slice kernels
#: (csrc/mega_ngp.cu kph::LFP, HP); cells of their adjoint's row, and its
#: most blocks.
SLICES_MAX_LF, SLICES_MAX_H = 128, 64
SLICES_ROW, SLICES_NBLK = 128, 264


def slices_fits(lf: int, h: int) -> bool:
    """LF <= 128 and H <= 64: the per-slice kernels' padded widths."""
    return 1 <= lf <= SLICES_MAX_LF and 1 <= h <= SLICES_MAX_H


def slices_fields_plain(encs, w1, b1, w2, b2, masks=None) -> FieldSnapshots:
    """The fields of the three slices from their encodings encs [3, nz, LF,
    ny, nx]: y_s = W2^T relu(W1^T enc_s + b1) + b2 (masks: the ReLU's, given)."""
    w2d = w2.double()
    ys = []
    for s in range(3):
        pre = _products(encs[s], w1) + b1
        a1 = torch.clamp_min(pre, 0.0) if masks is None else pre * masks[s]
        ys.append(_mm64("zyxh,ho->zyxo", a1, w2d).to(pre.dtype) + b2)
    return _snapshots(ys)


def slices_fields_ref(encs, w1, b1, w2, b2) -> FieldSnapshots:
    """The referee's fields: the float32 forward's values (slices_fields_plain)
    and masks, the float64 head's derivatives (as head_fields_ref)."""
    with torch.no_grad():
        values = slices_fields_plain(encs, w1, b1, w2, b2)
        masks = [(_products(encs[s], w1) + b1) > 0 for s in range(3)]
    exact = slices_fields_plain(encs.double(), w1.double(), b1.double(), w2.double(), b2.double(), masks)
    return FieldSnapshots(*(_with_value(e, v) for e, v in zip(exact, values)))


def slices_head_loss_and_grad_plain(g: GridSpec, w: PhysWeights, encs, w1, b1, w2, b2):
    """The plain version of the per-slice kernel: float32 autograd through
    slices_fields_plain, the staged residuals and the loss (dEnc a tensor of
    its own)."""
    return _head_autograd(g, w, slices_fields_plain, (encs, w1, b1, w2, b2), True)


def slices_head_loss_and_grad_ref(g: GridSpec, w: PhysWeights, encs, w1, b1, w2, b2):
    """The referee of the per-slice kernel: autograd on slices_fields_ref,
    the residuals and the loss in float64, the results rounded to float32
    (dEnc a tensor of its own)."""
    return _head_autograd(g, w, slices_fields_ref, (encs, w1, b1, w2, b2), True)


def slices_head_loss_and_grad(g: GridSpec, w: PhysWeights, encs, w1, b1, w2, b2):
    """(loss [2], (dEnc [3, nz, LF, ny, nx], dW1 [LF, H], db1 [H],
    dW2 [H, 4], db2 [4])) from the slices' encodings encs [3, nz, LF, ny,
    nx] and the head (W1 [LF, H]: no time row), in f32: the kernel for
    CUDA tensors, the plain version for CPU tensors. The kernel writes dEnc
    over encs (its last pass, once nothing reads the encoding: 25.8 GB fewer
    at 256^3): on return a CUDA encs holds dEnc, so a caller that needs the
    encoding again passes a copy."""
    if not _build.uses_kernel(encs, w1, b1, w2, b2):
        return slices_head_loss_and_grad_plain(g, w, encs, w1, b1, w2, b2)
    lf, h = w1.shape
    _build.check_shape(encs, (3, g.nz, lf, g.ny, g.nx), "encs")
    _build.check_shape(b1, (h,), "b1")
    _build.check_shape(w2, (h, 4), "W2")
    _build.check_shape(b2, (4,), "b2")
    if not ngp_supported(g):
        raise ValueError(f"the NGP backward kernel takes central or upwind, not {g.scheme!r}")
    if not slices_fits(lf, h):
        raise ValueError(f"LF={lf}, H={h}: K5 on per-slice encodings takes LF <= {SLICES_MAX_LF}, "
                         f"H <= {SLICES_MAX_H}")
    dev = encs.device
    ncell = g.nz * g.ny * g.nx
    nblk = min(-(-ncell // SLICES_ROW), SLICES_NBLK)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    lfp, hp = SLICES_MAX_LF, SLICES_MAX_H
    w1p = torch.nn.functional.pad(w1, (0, hp - h, 0, lfp - lf)).contiguous()
    b1p = torch.nn.functional.pad(b1, (0, hp - h)).contiguous()
    w2p = torch.nn.functional.pad(w2, (0, 0, 0, hp - h)).contiguous()
    tile_parts = empty(2, g.nz, num_tiles(g))
    fbuf, gbuf = empty(12, g.nz, g.ny, g.nx), empty(4, g.nz, g.ny, g.nx)
    a1buf = empty(3, g.nz, hp, g.ny, g.nx)
    dw1_part, head_part, db2_part = empty(nblk, lfp, hp), empty(nblk, hp, 5), empty(nblk, 4)
    denc = encs
    dw1, dhead, db2 = empty(lfp, hp), empty(hp, 5), empty(4)
    ptrs = (encs, w1p, b1p, w2p, b2, fbuf, gbuf, a1buf, tile_parts, dw1_part, head_part, db2_part, denc, dw1, dhead,
            db2)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_ngp_kplanes(
            *[x.data_ptr() for x in ptrs],
            g.nx, g.ny, g.nz, lf, h, nblk, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            *[float(s) for s in ops_loss.loss_scales_f32(g, w)],
            _build.stream_ptr(dev),
        )
    _build.check(err, "NGP backward mega kernel on per-slice encodings", "K5", (tile_parts, denc, dw1, dhead, db2))
    _build.LAUNCHES["K5 kplanes"] += 1
    _, loss = finalize_partials(g, w, tile_parts)
    return loss, (denc, dw1[:lf, :h], dhead[:h, 0], dhead[:h, 1:5], db2)


# ---------------------------------------------------------------------------
# The shard-local build: a shard's rows on a pre-extended encoding
# ---------------------------------------------------------------------------


def _enc_positions(g: GridSpec, rows: torch.Tensor, z0: int, nz_local: int) -> torch.Tensor:
    """Where each global row of `rows` lies in a shard's pre-extended
    encoding (its rows mega_bwd.halo_rows): an owned row at its own slot
    (two rows on), another at its first slot."""
    hr = halo_rows(g, z0, nz_local, rows.device)
    first = (hr[None, :] == rows[:, None]).int().argmax(dim=1)
    own = (rows >= z0) & (rows < z0 + nz_local)
    return torch.where(own, rows - z0 + HALO, first)


def head_loss_and_grad_shard_plain(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, z0: int,
                                   nz_local: int, tier: str = "f32", need_denc: bool = True):
    """The plain version of the shard-local kernel: (raw plane partials of
    the owned rows [2, nz_local], (dEnc [nz_local, LF, ny, nx] or None, dW1,
    db1, dW2, db2)) from the pre-extended encoding enc [nz_local + 4, LF,
    ny, nx] (the rows mega_bwd.halo_rows gives), every field row's cotangent
    counted at its owner (mega_bwd.owned_cotangent_plain). "f32": autograd
    through the head; "bf16" and "f32_fastbwd": the tier's forward and
    head_backward_plain."""
    check_shard(g, z0, nz_local)
    _build.check_shape(enc, (nz_local + 2 * HALO,) + enc.shape[1:], "enc")
    if tier == "f32":
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (enc, w1, b1, w2, b2)]

            def fields_fn(rows):
                fs = head_fields_plain(xs[0][_enc_positions(g, rows, z0, nz_local)], *xs[1:], ts)
                return torch.stack(list(fs[:3])), torch.stack(list(fs[3:]))

            parts, outs, cts, _ = owned_cotangent_plain(g, w, fields_fn, z0, nz_local, enc.device)
            grads = torch.autograd.grad(outs, xs if need_denc else xs[1:], cts)
        denc = grads[0][HALO : HALO + nz_local] if need_denc else None
        return parts, (denc, *grads[-4:])
    kept = {}

    def fields_fn(rows):
        with torch.no_grad():
            e = enc[_enc_positions(g, rows, z0, nz_local)]
            tb1 = first_layer_bias(w1, b1, ts)
            base = _base(e, w1, tier)
            ys = _head_from_base(base, tb1, w2, b2, arithmetic=tier)
            if tier == "f32_fastbwd":
                base = _bf16(base)
            kept["a1s"] = [torch.clamp_min(base + tb1[:, s], 0.0) for s in range(3)]
            kept["enc"] = e
        return torch.stack(list(ys[:3])), torch.stack(list(ys[3:]))

    parts, _, (d_s, d_u), rows = owned_cotangent_plain(g, w, fields_fn, z0, nz_local, enc.device)
    gys = [torch.cat([d_s[s][..., None], torch.movedim(d_u[s], 0, -1)], dim=-1) for s in range(3)]
    denc, dw1c, db1, dtw1, dw2, db2 = head_backward_plain(kept["enc"], w1[:-1], kept["a1s"], gys, ts, w2, tier)
    own = (rows >= z0) & (rows < z0 + nz_local)
    return parts, (denc[own] if need_denc else None, torch.cat([dw1c, dtw1[None]]), db1, dw2, db2)


def head_loss_and_grad_shard_ref(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, z0: int, nz_local: int,
                                 tier: str = "f32", need_denc: bool = True):
    """The referee the f32 shard-local kernel is held to on the card, as
    head_loss_and_grad_ref is the whole grid's: the shard-local plain
    version on head_fields_ref (the float32 forward's values, the
    derivatives, residuals and loss in float64); the results rounded to
    float32."""
    _f32_only(tier)
    check_shard(g, z0, nz_local)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (enc, w1, b1, w2, b2)]

        def fields_fn(rows):
            fs = head_fields_ref(xs[0][_enc_positions(g, rows, z0, nz_local)], *xs[1:], ts)
            return torch.stack(list(fs[:3])), torch.stack(list(fs[3:]))

        parts, outs, cts, _ = owned_cotangent_plain(g, w, fields_fn, z0, nz_local, enc.device)
        grads = torch.autograd.grad(outs, xs if need_denc else xs[1:], cts)
    denc = grads[0][HALO : HALO + nz_local] if need_denc else None
    return parts.float(), (denc, *(x.float() for x in grads[-4:]))


def head_loss_and_grad_shard(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, z0: int, nz_local: int,
                             tier: str = "f32", need_denc: bool = True):
    """The shard-local kernel (the rows [z0, z0 + nz_local) of g on the
    pre-extended encoding enc [nz_local + 4, LF, ny, nx] of the rows
    mega_bwd.halo_rows gives; the clamp edges on global rows) for CUDA
    tensors, its plain version for CPU tensors: (raw plane partials
    [2, nz_local], (dEnc of the owned rows or None, dW1, db1, dW2, db2)),
    the owned rows' part of the sums."""
    check_shard(g, z0, nz_local)
    if not _build.uses_kernel(enc, w1, b1, w2, b2, ts):
        return head_loss_and_grad_shard_plain(g, w, enc, w1, b1, w2, b2, ts, z0, nz_local, tier, need_denc)
    if nz_local == g.nz:  # one shard: the whole grid's frame
        enc = enc[HALO : HALO + nz_local].contiguous()
    counter = "mega_ngp shard" if tier == "f32" else f"mega_ngp {tier} shard"
    parts, _, grads = _launch(g, w, enc, w1, b1, w2, b2, ts, tier, need_denc, z0, nz_local, counter)
    return parts, grads


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _t_value(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(device=device, dtype=torch.float32)
    # a fill, not a host-to-device copy
    return torch.full((), float(np.float32(t)), dtype=torch.float32, device=device)


def _zeros_for_unused(grads, like) -> list:
    return [torch.zeros_like(x) if gr is None else gr for gr, x in zip(grads, like)]


def _slices_loss_and_grad(g, w, ncfg, params, t, tier, slices_fn):
    """_loss_and_grad of a time-aware encoding: the three slices' encodings,
    the per-slice head, their three dEnc pulled back at once; grad_t None
    (t enters through the encoder: ngp_loss_and_grad_plain gives it)."""
    if tier != "f32":
        raise ValueError(f"the {encoders.family_of(ncfg.encoding).name!r} encoding depends on t: K5 runs it in the "
                         f"f32 tier alone, not {tier!r}")
    w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
    ts = slice_times(_t_value(t, w1.device), g.dt)
    tables = params["tables"]
    tab = tree.map_tree(lambda x: x.detach().requires_grad_(), tables)
    with torch.enable_grad():
        encs = encoders.encode_grid_zcf_slices(ncfg.encoding, tab, g, ts)
    # the pull-back needs no encoding (the kernels keep their node tables), so
    # the kernel may write dEnc over it
    loss, (denc, dw1, db1, dw2, db2) = slices_fn(g, w, encs.detach().contiguous(), w1, b1, w2, b2)
    leaves = tree.leaves(tab)
    with annotate("pat.encode.pullback"):
        d_leaves = torch.autograd.grad(encs, leaves, denc, allow_unused=True)
    gp = {"tables": tree.unflatten(tables, _zeros_for_unused(d_leaves, leaves)), "W1": dw1, "b1": db1, "W2": dw2,
          "b2": db2}
    return loss[0] + loss[1], (gp, None)


def _loss_and_grad(g, w, ncfg, params, t, precision, head_fn, slices_fn):
    tier = ngp_mod.check_precision(precision, "K5")
    if ncfg.out != 4:
        raise ValueError("the NGP backward kernel's head has the 4 physics channels")
    if encoders.time_aware(ncfg.encoding):
        return _slices_loss_and_grad(g, w, ncfg, params, t, tier, slices_fn)
    tables = params["tables"]
    has_enc = any(x.numel() > 0 for x in tree.leaves(tables))
    w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
    ts = slice_times(_t_value(t, w1.device), g.dt)
    tab = tree.map_tree(lambda x: x.detach().requires_grad_(has_enc), tables)
    with torch.enable_grad():
        # the bf16 tier reads the fast encode, as the JAX kernel's caller does
        enc = encoders.encode_grid_zcf(ncfg.encoding, tab, g, fast=tier == "bf16")
    loss, (denc, dw1, db1, dw2, db2) = head_fn(
        g, w, enc.detach().contiguous(), w1, b1, w2, b2, ts, tier, need_denc=has_enc
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


def ngp_loss_and_grad(g: GridSpec, w: PhysWeights, ncfg, params: dict, t, precision: str = "f32"):
    """(loss, (grad_params, grad_t)) of the encoded-field model from ONE call
    of the NGP backward mega-kernel (CUDA params) or its plain version (CPU
    params), plus the encoder's pull-back. The gradients are those of
    ops.total_loss(g, w, ngp.generate_fields(...)), as a tree shaped like
    `params`, in the arithmetic of the tier `precision` (see the module
    docstring; "bf16" encodes with the fast encode). A time-aware encoding
    runs the per-slice kernel (f32 alone) and gives grad_t None."""
    return _loss_and_grad(g, w, ncfg, params, t, precision, head_loss_and_grad, slices_head_loss_and_grad)


def ngp_loss_and_grad_sharded(g: GridSpec, w: PhysWeights, ncfg, mesh, precision: str = "f32"):
    """Returns fn(params, t) -> (loss, (grad_params, grad_t)) over the z mesh
    (parallel/mesh.ZMesh; JAX pallas/mega_ngp.py:635-730): each rank
    encodes its own rows and two halo rows a side (encoders.
    encode_grid_zcf_rows, so the encoder weak-scales and no halo is
    exchanged) and runs the shard-local kernel (its plain version for CPU
    params); its dEnc covers its own rows, zero at the halo positions, so
    each row's cotangent reaches the tables once, through the shard-local
    encoder's pull-back; the table and head gradients are all-reduced and
    the loss chained from the gathered plane partials in global z order."""
    tier = ngp_mod.check_precision(precision, "K5")
    encoders.check_time_free(ncfg.encoding, "the sharded NGP step")
    z0, nz_local = mesh.rows(g.nz)
    if ncfg.out != 4:
        raise ValueError("the NGP backward kernel's head has the 4 physics channels")

    def loss_and_grad(params, t):
        tables = params["tables"]
        has_enc = any(x.numel() > 0 for x in tree.leaves(tables))
        w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
        ts = slice_times(_t_value(t, w1.device), g.dt)
        tab = tree.map_tree(lambda x: x.detach().requires_grad_(has_enc), tables)
        rows = halo_rows(g, z0, nz_local)  # host rows: the encoder reads them on the host
        with torch.enable_grad():
            enc = encoders.encode_grid_zcf_rows(ncfg.encoding, tab, g, rows, fast=tier == "bf16")
        parts, (denc, dw1, db1, dw2, db2) = head_loss_and_grad_shard(
            g, w, enc.detach().contiguous(), w1, b1, w2, b2, ts, z0, nz_local, tier, need_denc=has_enc
        )
        loss = sum_plane_partials(g, w, mesh.all_gather(parts, 1))
        if has_enc:
            denc_ext = torch.nn.functional.pad(denc, (0, 0, 0, 0, 0, 0, HALO, HALO))
            leaves = tree.leaves(tab)
            d_leaves = _zeros_for_unused(torch.autograd.grad(enc, leaves, denc_ext, allow_unused=True), leaves)
            d_tables = tree.unflatten(tables, [mesh.all_reduce(x) for x in d_leaves])
        else:
            d_tables = tree.map_tree(torch.zeros_like, tables)
        dw1, db1, dw2, db2 = (mesh.all_reduce(x) for x in (dw1, db1, dw2, db2))
        gp = {"tables": d_tables, "W1": dw1, "b1": db1, "W2": dw2, "b2": db2}
        return loss[0] + loss[1], (gp, torch.sum(w1[-1] * db1))

    return loss_and_grad


def ngp_loss_and_grad_ref(g: GridSpec, w: PhysWeights, ncfg, params: dict, t, precision: str = "f32"):
    """ngp_loss_and_grad with the referee head (head_loss_and_grad_ref) in
    the kernel's place: the same encoder pull-back, on any device."""
    return _loss_and_grad(g, w, ncfg, params, t, precision, head_loss_and_grad_ref, slices_head_loss_and_grad_ref)


def ngp_loss_and_grad_plain(g: GridSpec, w: PhysWeights, ncfg, params: dict, t, precision: str = "f32"):
    """The plain version of ngp_loss_and_grad, on any device: autograd
    through ngp.generate_fields -> ops.total_loss."""
    ngp_mod.check_precision(precision, "K5")
    with torch.enable_grad():
        p = tree.map_tree(lambda x: x.detach().requires_grad_(), params)
        tt = _t_value(t, params["W1"].device).requires_grad_()
        loss = ops_loss.total_loss(g, w, ngp_mod.generate_fields(g, ncfg, p, tt, g.dt, precision))
        leaves = tree.leaves(p) + [tt]
        grads = _zeros_for_unused(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)
    return loss.detach(), (tree.unflatten(params, grads[:-1]), grads[-1])
