"""The fused training loss and the slab-recompute gradient (port of
phys_autodiff_tpu/train/slab_grad.py).

`make_fused_loss(...)(params, t)` is the scalar loss L_sigma + L_u with a
fused path in both directions. The forward is the MLP -> residual -> loss
mega-kernel K3 (kernels/mega.py) within its gate, else K2 -> K1
(kernels/mlp.fused_loss_pipeline), as the JAX module routes deep grids
(:225-236). The backward is the backward mega-kernel K4
(kernels/mega_bwd.py) within its gate (`mega_fits(g, H, tier)`: H <= 1300
in f32, 1360 in bf16 on an H100), else the slab-recompute gradient below;
the autograd.Function scales either gradient by the cotangent. On CPU
params the kernels run their plain versions; the gates route the same way
on every device.

The slab-recompute gradient (`make_slab_loss_and_grad`): with L_k the raw
weighted residual-square sum of the z-slab k,

    L = 1/N sum_k L_k,    grad L = 1/N sum_k grad L_k,

and each L_k recomputes its fields from the MLP on the slab extended by one
halo row a side (the z boundary encoded by wrapped or clamped row indices,
`make_slab_raw`), so autograd of L_k gives the exact global gradient while
only slab-sized activations exist: the [3N, H] hidden activations shrink to
[3 (sz + 2) ny nx, H]. The slab's fields use the rank-1 form of layer 1
(`slab_fields_rows`: a sum of per-axis tables, as the kernels fold it);
layer 2 is one matmul, in the arithmetic of the tier (kernels/_build.TIERS
["K4"]: "bf16" rounds a1 and W2 to bf16 with float32 sums, and its backward
rounds each operand's gradient as JAX's cast VJP does; "f32", "f32_high"
and "bf16x3" are float32). Plain PyTorch ops and autograd: nothing here is
a kernel. The sharded fused step (parallel/sharded.py) builds on
`make_slab_raw`, so a slab's value is the same there and here.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega import mega_fwd_fits, mega_loss_pipeline
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_fits, mega_loss_and_grad, mega_supported
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS, fused_loss_pipeline
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.coords import _axis_coord, time_offset
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.models.ngp import _MatmulBf16
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops.stencil import residuals_zext, z_rows
from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights

#: Per-slab hidden-activation budget (bytes) that picks the slab height.
_A1_BUDGET = 192 * 1024 * 1024

BACKWARDS = ("auto", "mega", "slab")


def pick_slab_rows(g: GridSpec, h: int, budget: int = _A1_BUDGET) -> int:
    """The largest divisor of nz whose slab activations (three slices of
    sz + 2 rows, H float32 a cell) fit the budget."""
    row_bytes = 3 * g.ny * g.nx * h * 4
    best = 1
    for sz in range(1, g.nz + 1):
        if g.nz % sz == 0 and (sz + 2) * row_bytes <= budget:
            best = sz
    return best


def slab_fields_rows(
    g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, ts: torch.Tensor, z_idx: torch.Tensor,
    precision: str = "f32",
):
    """The MLP's fields at the given z rows (global indices, already wrapped
    or clamped) for the slice times ts [S] -> (sigma [S, R, ny, nx],
    u [S, 3, R, ny, nx]).

    Layer 1 in rank-1 form: z1[s, r, y, x, h] = (cx[x] W1x[h] + cy[y] W1y[h])
    + (cz[r] W1z[h] + ((ts[s] + off) W1t[h] + b1[h])); only layer 2
    contracts (K = H), in the arithmetic of `precision` (TIERS["K4"])."""
    tier = _build.check_precision(precision, "K4")
    w1 = params["W1"]
    dev = w1.device
    cx = _axis_coord(g.nx, cfg.norm, dev)
    cy = _axis_coord(g.ny, cfg.norm, dev)
    cz = _axis_coord(g.nz, cfg.norm, dev)[z_idx.to(dev)]
    ax = cx[:, None] * w1[0][None, :]  # [nx, H]
    ay = cy[:, None] * w1[1][None, :]  # [ny, H]
    az = cz[:, None] * w1[2][None, :]  # [R, H]
    at = (ts.to(dev) + float(np.float32(time_offset(cfg.norm))))[:, None] * w1[3][None, :] + params["b1"]
    # two small tables first, so the full-size tensor takes one add
    ab = ax[None, :, :] + ay[:, None, :]  # [ny, nx, H]
    cd = az[None, :, :] + at[:, None, :]  # [S, R, H]
    a1 = torch.clamp_min(ab[None, None] + cd[:, :, None, None], 0.0)  # [S, R, ny, nx, H]
    w2 = params["W2"]
    y = (_MatmulBf16.apply(a1, w2) if tier == "bf16" else torch.matmul(a1, w2)) + params["b2"]
    return y[..., 0], torch.movedim(y[..., 1:4], -1, 1)


def make_slab_raw(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, sz: int | None = None,
                  precision: str = "f32"):
    """Returns (slab_raw, sz): slab_raw(params, t, k) is the raw
    (unnormalised) weighted residual-square sum of z-slab k, its fields
    recomputed from the MLP on a one-row halo extension. The building block
    of the single-device slab gradient and of the sharded fused step
    (parallel/sharded.py): a slab's value is the same in both."""
    if sz is None:
        sz = pick_slab_rows(g, cfg.dims.H)
    if g.nz % sz != 0:
        raise ValueError(f"slab rows {sz} must divide nz={g.nz}")
    _build.check_precision(precision, "K4")
    ws, wu = float(np.float32(w.w_sigma)), float(np.float32(w.w_u))

    def slab_raw(params, t, k: int):
        ts = slice_times(t, g.dt)
        if not isinstance(ts, torch.Tensor):
            ts = torch.tensor(np.asarray(ts, np.float32))
        # slab k's rows and one halo row a side
        rows = z_rows(g, k * sz - 1, k * sz + sz + 1, params["W1"].device)
        sigma, u = slab_fields_rows(g, cfg, params, ts, rows, precision)
        rs, ru = residuals_zext(g, sigma, u)
        return ws * torch.sum(rs * rs) + wu * torch.sum(ru * ru)

    return slab_raw, sz


def _t_leaf(t, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(device=device, dtype=torch.float32).requires_grad_()
    return torch.tensor(float(np.float32(t)), dtype=torch.float32, device=device, requires_grad=True)


def slab_value_and_grad(slab_raw, params: mlp.Params, t, k: int):
    """(L_k, (grads of the params, grad of t)) of one slab, by autograd."""
    with torch.enable_grad():
        p = [params[key].detach().requires_grad_() for key in _PARAM_KEYS]
        tt = _t_leaf(t, p[0].device)
        lk = slab_raw(dict(zip(_PARAM_KEYS, p)), tt, k)
        grads = torch.autograd.grad(lk, p + [tt])
    return lk.detach(), (dict(zip(_PARAM_KEYS, grads[:4])), grads[4])


def make_slab_loss_and_grad(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, sz: int | None = None,
                            precision: str = "f32"):
    """Returns fn(params, t) -> (loss, (grad_params, grad_t)): the staged
    total loss (the same residual math and 1/N) and its gradient, summed
    slab by slab in a fixed order."""
    slab_raw, sz = make_slab_raw(g, w, cfg, sz, precision)
    inv_n = float(ops_loss.inv_n_f32(g))

    def loss_and_grad(params, t):
        raw_l, gp, gt = None, None, None
        for k in range(g.nz // sz):
            lk, (gk, gtk) = slab_value_and_grad(slab_raw, params, t, k)
            if raw_l is None:
                raw_l, gp, gt = lk, gk, gtk
            else:
                raw_l, gt = raw_l + lk, gt + gtk
                gp = {key: gp[key] + gk[key] for key in _PARAM_KEYS}
        return raw_l * inv_n, ({key: v * inv_n for key, v in gp.items()}, gt * inv_n)

    return loss_and_grad


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, forward_fn, grad_fn, t, *weights):
        ctx.grad_fn, ctx.t = grad_fn, t
        ctx.save_for_backward(*weights)
        ls, lu = forward_fn(dict(zip(_PARAM_KEYS, weights)), t)
        return ls + lu

    @staticmethod
    def backward(ctx, ct):
        t = ctx.t
        _, (gp, gt) = ctx.grad_fn(dict(zip(_PARAM_KEYS, ctx.saved_tensors)), t)
        d_t = ct * gt.to(t.device) if isinstance(t, torch.Tensor) and ctx.needs_input_grad[2] else None
        return (None, None, d_t, *(ct * gp[k] for k in _PARAM_KEYS))


def uses_mega_backward(g: GridSpec, cfg: MLPGridConfig, precision: str = "f32", sz: int | None = None,
                       backward: str = "mega") -> bool:
    """Whether make_fused_loss's backward is K4: "mega" within K4's gate of
    the tier, "auto" there too unless a slab height is given, "slab"
    never."""
    if backward not in BACKWARDS:
        raise ValueError(f"backward must be one of {BACKWARDS}, not {backward!r}")
    tier = _build.check_precision(precision, "K4")
    gate = mega_supported(g) and mega_fits(g, cfg.dims.H, tier)
    return gate and (backward == "mega" or (backward == "auto" and sz is None))


def make_fused_loss(g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, precision: str = "f32",
                    sz: int | None = None, backward: str = "mega"):
    """Returns loss(params, t) -> scalar tensor: K3 (or K2 -> K1 past K3's
    gate) forward; K4 backward, or the slab-recompute gradient where K4's
    gate fails or backward="slab" (sz: its slab height)."""
    tier3 = _build.check_precision(precision, "K3")
    if mega_fwd_fits(g, cfg.dims.H, tier3):
        def forward_fn(params, t):
            return mega_loss_pipeline(g, w, cfg, params, t, precision)
    else:
        def forward_fn(params, t):
            return fused_loss_pipeline(g, w, cfg, params, t, precision)

    if uses_mega_backward(g, cfg, precision, sz, backward):
        def grad_fn(params, t):
            return mega_loss_and_grad(g, w, cfg, params, t, precision)
    else:
        grad_fn = make_slab_loss_and_grad(g, w, cfg, sz, precision)

    def loss(params: mlp.Params, t):
        return _FusedLoss.apply(forward_fn, grad_fn, t, *(params[k] for k in _PARAM_KEYS))

    return loss
