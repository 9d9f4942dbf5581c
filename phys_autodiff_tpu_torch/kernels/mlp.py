"""K2: fused MLP field generation (port of phys_autodiff_tpu/pallas/mlp.py;
CUDA source csrc/mlp.cu).

Grid coordinates are separable, so layer 1 folds into rank-1 tables
(plain tensor ops, as they were plain XLA outside the Pallas kernel):

    AB[h, y, x] = W1[x,h]*cx[x] + W1[y,h]*cy[y]                [H, ny, nx]
    CD[z, h, s] = W1[z,h]*cz[z] + W1[t,h]*(t_s + t_off) + b1[h]  [nz, H, S]

and the kernel computes y = W2^T relu(AB + CD) + b2 for S time slices,
writing sigma/u channel-major or straight into PACKED_ORDER. The ZeroToOne
t + 0.5 quirk lives in `fold_cd` (as in the JAX package).

Entry points run the plain PyTorch version of the table MLP for CPU
tensors and launch the kernel for CUDA tensors (the device follows the
params). The kernel takes any grid: there is no nx % 128 gate and no
staged fallback. The 3-slice entry points are differentiable in the
params and t: an autograd.Function whose backward is autograd through the
staged models.fields.generate_fields (the JAX custom_vjps,
pallas/mlp.py:394-459 and :481-537).
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.residuals import loss_forward_fused_packed, pack_fields
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.coords import _axis_coord, time_offset
from phys_autodiff_tpu_torch.models.fields import generate_fields, slice_times
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

def fold_ab_plane(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params) -> torch.Tensor:
    """AB[h, y, x] = W1[x,h]*cx[x] + W1[y,h]*cy[y]  ->  [H, ny, nx]."""
    w1 = params["W1"]
    cx = _axis_coord(g.nx, cfg.norm, w1.device)
    cy = _axis_coord(g.ny, cfg.norm, w1.device)
    a = w1[0][:, None] * cx[None, :]  # [H, nx]
    b = w1[1][:, None] * cy[None, :]  # [H, ny]
    return a[:, None, :] + b[:, :, None]


def fold_cd(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, ts) -> torch.Tensor:
    """CD[z, h, s] = W1[z,h]*cz[z] + W1[t,h]*(t_s + t_off) + b1[h]  ->  [nz, H, S].
    ts: float32 slice times (models.fields.slice_times), host values or a
    tensor that autograd follows back to t."""
    w1 = params["W1"]
    cz = _axis_coord(g.nz, cfg.norm, w1.device)
    c = cz[:, None] * w1[2][None, :]  # [nz, H]
    if isinstance(ts, torch.Tensor):
        t_in = ts.to(w1.device) + float(np.float32(time_offset(cfg.norm)))
        d = t_in[:, None] * w1[3][None, :] + params["b1"][None, :]  # [S, H]
    else:
        t_in = np.asarray(ts, np.float32) + np.float32(time_offset(cfg.norm))
        d = torch.stack([float(v) * w1[3] + params["b1"] for v in t_in])  # [S, H]
    return c[:, :, None] + d.T[None, :, :]


def fold_tables(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, ts):
    """(AB [H, ny, nx], CD [nz, H, S], W2T [4, H], b2 [4]), contiguous."""
    return (
        fold_ab_plane(g, cfg, params).contiguous(),
        fold_cd(g, cfg, params, ts).contiguous(),
        params["W2"].T.contiguous(),
        params["b2"].contiguous(),
    )


def mlp_tables_plain(ab, cd, w2t, b2):
    """The plain version of the kernel: y = W2^T relu(AB + CD) + b2.
    Returns sigma [S, nz, ny, nx] and u [S, 3, nz, ny, nx]."""
    z1 = ab[None, None] + cd.permute(2, 0, 1)[:, :, :, None, None]  # [S, nz, H, ny, nx]
    a1 = torch.clamp_min(z1, 0.0)
    y = torch.einsum("oh,snhyx->snoyx", w2t, a1) + b2[None, None, :, None, None]
    return y[:, :, 0], y[:, :, 1:4].transpose(1, 2)


def check_dims(cfg: MLPGridConfig, params: mlp.Params) -> None:
    if cfg.dims.In != 4 or cfg.dims.Out != 4:
        raise ValueError("the fused MLP takes In = Out = 4")
    h = params["W1"].shape[1]
    _build.check_shape(params["W1"], (4, h), "W1")
    _build.check_shape(params["b1"], (h,), "b1")
    _build.check_shape(params["W2"], (h, 4), "W2")
    _build.check_shape(params["b2"], (4,), "b2")


def _launch(g: GridSpec, ab, cd, w2t, b2, sigma_out, u_out) -> None:
    """One launch writing S slices: sigma channel s at sigma_out + s*N,
    u channel c of slice s at u_out + (3s + c)*N (N = nz*ny*nx)."""
    h, s = cd.shape[1], cd.shape[2]
    dev = ab.device
    with torch.cuda.device(dev):
        err = _build.lib().pat_mlp_fields(
            ab.data_ptr(), cd.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
            sigma_out.data_ptr(), u_out.data_ptr(),
            g.ny * g.nx, g.nz, h, s, _build.stream_ptr(dev),
        )
    _build.check(err, "mlp kernel")
    _build.LAUNCHES["mlp"] += 1


def _fields(g, cfg, params, ts, precision, packed: bool):
    """S-slice fields: (sigma [S,...], u [S,3,...]) or packed [4S, ...]."""
    _build.check_precision(precision, "K2")
    check_dims(cfg, params)
    tables = fold_tables(g, cfg, params, ts)
    if not _build.uses_kernel(*params.values()):
        sigma, u = mlp_tables_plain(*tables)
        if packed:
            return torch.cat([sigma, u.reshape((-1,) + g.shape)], dim=0)
        return sigma, u
    n_s, dev = len(ts), params["W1"].device
    if packed:
        out = torch.empty((4 * n_s,) + g.shape, dtype=torch.float32, device=dev)
        _launch(g, *tables, out, out[n_s:])
        return out
    sigma = torch.empty((n_s,) + g.shape, dtype=torch.float32, device=dev)
    u = torch.empty((n_s, 3) + g.shape, dtype=torch.float32, device=dev)
    _launch(g, *tables, sigma, u)
    return sigma, u


_PARAM_KEYS = ("W1", "b1", "W2", "b2")


class _Fields(torch.autograd.Function):
    """The 3-slice fields of the params W1, b1, W2, b2 at t (a float, or a
    tensor that gets a gradient): (sigma [3,...], u [3,3,...]), or packed
    [12, ...] (PACKED_ORDER)."""

    @staticmethod
    def forward(ctx, g, cfg, precision, packed, t, *weights):
        ctx.g, ctx.cfg, ctx.packed, ctx.t = g, cfg, packed, t
        ctx.save_for_backward(*weights)
        out = _fields(g, cfg, dict(zip(_PARAM_KEYS, weights)), slice_times(t, g.dt), precision, packed)
        return out

    @staticmethod
    def backward(ctx, *cots):
        g, cfg, t = ctx.g, ctx.cfg, ctx.t
        t_grad = isinstance(t, torch.Tensor) and ctx.needs_input_grad[4]
        with torch.enable_grad():
            ws = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            tt = t.detach().requires_grad_() if t_grad else t
            fs = generate_fields(g, cfg, dict(zip(_PARAM_KEYS, ws)), tt, g.dt)
            if ctx.packed:
                outs = (pack_fields(fs),)
            else:
                outs = (torch.stack(fs[:3]), torch.stack(fs[3:]))
        inputs = ws + ([tt] if t_grad else [])
        grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
        d_t = grads[4] if t_grad else None
        return (None, None, None, None, d_t, *grads[:4])


def _apply_fields(g, cfg, params, t, precision, packed):
    return _Fields.apply(g, cfg, precision, packed, t, *(params[k] for k in _PARAM_KEYS))


def generate_fields_fused(
    g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
) -> FieldSnapshots:
    """MLP -> physics fields at t-dt, t, t+dt in one kernel pass;
    differentiable in the params and in a tensor t."""
    sigma, u = _apply_fields(g, cfg, params, t, precision, packed=False)
    return FieldSnapshots(sigma[0], sigma[1], sigma[2], u[0], u[1], u[2])


def generate_fields_fused_packed(
    g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
) -> torch.Tensor:
    """Like generate_fields_fused but emits packed [12, nz, ny, nx]
    (PACKED_ORDER) straight from the kernel."""
    return _apply_fields(g, cfg, params, t, precision, packed=True)


def grid_infer_fused(
    g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
) -> torch.Tensor:
    """Single-time grid inference -> [nz, ny, nx, 4]."""
    ts = np.array([t], dtype=np.float32)
    sigma, u = _fields(g, cfg, params, ts, precision, packed=False)
    return torch.cat([sigma[0][..., None], torch.movedim(u[0], 0, -1)], dim=-1)


def fused_loss_pipeline(
    g: GridSpec, w: PhysWeights, cfg: MLPGridConfig, params: mlp.Params, t, precision: str = "f32"
):
    """Fused field generation (packed) -> fused loss kernel -> (L_sigma, L_u);
    differentiable by composition of the two autograd Functions."""
    packed = generate_fields_fused_packed(g, cfg, params, t, precision)
    return loss_forward_fused_packed(g, w, packed, precision)

