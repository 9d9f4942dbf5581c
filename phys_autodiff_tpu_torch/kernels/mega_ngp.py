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
block's shared memory, which bounds LF x H further (`ngp_fits`). A shape
outside the gates raises; there is no other path for CUDA tensors. Only
precision="f32" is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.residuals import TILE_X, TILE_Y, finalize_partials, num_tiles
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.config import GridSpec, PhysWeights

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


def ngp_fits(lf: int, h: int) -> bool:
    """LF <= 64, H <= 256 and the adjoint pass's shared memory fits a block
    (LF = 16, H = 64 take 102 KB; at LF = 16 H reaches 179)."""
    return 1 <= lf <= MAX_LF and 1 <= h <= MAX_H and smem_bytes(lf, h) + SMEM_STATIC <= SMEM_LIMIT


def _check_gates(g: GridSpec, lf: int, h: int) -> None:
    if not ngp_supported(g):
        raise ValueError(f"the NGP backward kernel takes central or upwind, not {g.scheme!r}")
    if not ngp_fits(lf, h):
        raise ValueError(
            f"LF={lf}, H={h}: the NGP backward kernel takes LF <= {MAX_LF}, H <= {MAX_H} and "
            f"{SMEM_LIMIT} B of shared memory a block (this needs {smem_bytes(lf, h)} B)"
        )


# ---------------------------------------------------------------------------
# The head: the kernel, its plain version and the referee
# ---------------------------------------------------------------------------


def first_layer_bias(w1, b1, ts):
    """tb1 = b1 + W1[-1] t_s [H, 3]: the first layer's bias at the slices
    t-dt, t, t+dt (the time input folded in)."""
    return b1[:, None] + w1[-1][:, None] * ts[None, :]


def _head_from_base(base, tb1, w2, b2, masks=None) -> FieldSnapshots:
    ys = []
    for s in range(3):
        pre = base + tb1[:, s]
        a1 = torch.clamp_min(pre, 0.0) if masks is None else pre * masks[s]
        ys.append(torch.matmul(a1, w2) + b2)
    sig = [y[..., 0] for y in ys]
    u = [torch.movedim(y[..., 1:4], -1, 0) for y in ys]
    return FieldSnapshots(sig[0], sig[1], sig[2], u[0], u[1], u[2])


def _base(enc, w1):
    return torch.einsum("zcyx,ch->zyxh", enc, w1[:-1])


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


def _head_autograd(g, w, fields_fn, inputs, ts, need_denc):
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        fields = fields_fn(*xs, ts)
        ls, lu = ops_loss.sum_partials(g, w, ops_loss.plane_partials(*ops_stencil.residuals(g, fields)))
        grads = torch.autograd.grad(ls + lu, xs if need_denc else xs[1:])
    if not need_denc:
        grads = (None, *grads)
    return torch.stack([ls, lu]).detach().float(), tuple(grads)


def head_loss_and_grad_plain(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, need_denc: bool = True):
    """The plain version of the kernel: (loss [2], (dEnc or None, dW1, db1,
    dW2, db2)) by float32 autograd through the head, the staged residuals,
    the plane partials and their fixed-order sum."""
    return _head_autograd(g, w, head_fields_plain, (enc, w1, b1, w2, b2), ts, need_denc)


def head_loss_and_grad_ref(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, need_denc: bool = True):
    """The referee the kernel is held to: autograd as in the plain version,
    on head_fields_ref, the residuals and the loss in float64; the
    gradients rounded to float32. float64, so that the check measures the
    kernel's rounding: the t -+ dt cotangents are 1/(2 dt) times the t
    slice's and nearly cancel, and float32 autograd sums them slice by
    slice (about 1e-4 of dW2 lost at 128x96x96)."""
    return _head_autograd(g, w, head_fields_ref, (enc, w1, b1, w2, b2), ts, need_denc)


def head_loss_and_grad(g: GridSpec, w: PhysWeights, enc, w1, b1, w2, b2, ts, need_denc: bool = True):
    """(loss [2], (dEnc or None, dW1 [LF+1, H], db1 [H], dW2 [H, 4],
    db2 [4])) from the encoding [nz, LF, ny, nx], the head and the slice
    times ts [3]: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not _build.uses_kernel(enc, w1, b1, w2, b2, ts):
        return head_loss_and_grad_plain(g, w, enc, w1, b1, w2, b2, ts, need_denc)
    lf, h = w1.shape[0] - 1, w1.shape[1]
    _build.check_shape(enc, (g.nz, lf, g.ny, g.nx), "enc")
    _build.check_shape(b1, (h,), "b1")
    _build.check_shape(w2, (h, 4), "W2")
    _build.check_shape(b2, (4,), "b2")
    _build.check_shape(ts, (3,), "ts")
    _check_gates(g, lf, h)
    nblk = num_blocks(g)
    dev = enc.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tb1 = first_layer_bias(w1, b1, ts).contiguous()
    tile_parts = empty(2, g.nz, num_tiles(g))
    fbuf, gbuf = empty(12, *g.shape), empty(4, *g.shape)
    dw1_part, head_part, db2_part = empty(nblk, lf, h), empty(nblk, h, 6), empty(nblk, 4)
    denc = empty(g.nz, lf, g.ny, g.nx) if need_denc else None
    dw1c, dhead, db2 = empty(lf, h), empty(h, 6), empty(4)
    # W1[:-1] is the leading LF rows of the contiguous W1
    ptrs = (enc, w1, tb1, ts, w2, b2, fbuf, gbuf, tile_parts, dw1_part, head_part, db2_part, denc,
            dw1c, dhead, db2)
    with torch.cuda.device(dev):
        err = _build.lib().pat_mega_ngp(
            *[x.data_ptr() if x is not None else None for x in ptrs],
            g.nx, g.ny, g.nz, lf, h, nblk, int(g.periodic), int(g.scheme == "upwind"),
            *[float(ops_stencil.inv2h_f32(v)) for v in (g.dt, g.hx, g.hy, g.hz)],
            *[float(s) for s in ops_loss.loss_scales_f32(g, w)],
            _build.stream_ptr(dev),
        )
    _build.check(err, "NGP backward mega kernel")
    _build.LAUNCHES["mega_ngp"] += 1
    _, loss = finalize_partials(g, w, tile_parts)
    dw1 = torch.cat([dw1c, dhead[None, :, 1]])
    return loss, (denc, dw1, dhead[:, 0], dhead[:, 2:], db2)


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


def _loss_and_grad(g, w, ncfg, params, t, precision, head_fn):
    ngp_mod.check_precision(precision, "K5")
    if ncfg.out != 4:
        raise ValueError("the NGP backward kernel's head has the 4 physics channels")
    tables = params["tables"]
    has_enc = any(x.numel() > 0 for x in tree.leaves(tables))
    w1, b1, w2, b2 = (params[k].detach().contiguous() for k in ("W1", "b1", "W2", "b2"))
    ts = slice_times(_t_value(t, w1.device), g.dt)
    tab = tree.map_tree(lambda x: x.detach().requires_grad_(has_enc), tables)
    with torch.enable_grad():
        enc = encoders.encode_grid_zcf(ncfg.encoding, tab, g)
    loss, (denc, dw1, db1, dw2, db2) = head_fn(
        g, w, enc.detach().contiguous(), w1, b1, w2, b2, ts, need_denc=has_enc
    )
    if has_enc:
        leaves = tree.leaves(tab)
        d_tables = tree.unflatten(
            tables, _zeros_for_unused(torch.autograd.grad(enc, leaves, denc, allow_unused=True), leaves)
        )
    else:
        d_tables = tree.map_tree(torch.zeros_like, tables)
    gp = {"tables": d_tables, "W1": dw1, "b1": db1, "W2": dw2, "b2": db2}
    return loss[0] + loss[1], (gp, torch.sum(w1[-1] * db1))


def ngp_loss_and_grad(g: GridSpec, w: PhysWeights, ncfg, params: dict, t, precision: str = "f32"):
    """(loss, (grad_params, grad_t)) of the encoded-field model from ONE call
    of the NGP backward mega-kernel (CUDA params) or its plain version (CPU
    params), plus the encoder's pull-back. The gradients are those of
    ops.total_loss(g, w, ngp.generate_fields(...)), as a tree shaped like
    `params`."""
    return _loss_and_grad(g, w, ncfg, params, t, precision, head_loss_and_grad)


def ngp_loss_and_grad_ref(g: GridSpec, w: PhysWeights, ncfg, params: dict, t, precision: str = "f32"):
    """ngp_loss_and_grad with the referee head (head_loss_and_grad_ref) in
    the kernel's place: the same encoder pull-back, on any device."""
    return _loss_and_grad(g, w, ncfg, params, t, precision, head_loss_and_grad_ref)


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
