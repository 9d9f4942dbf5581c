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
params). The kernel (csrc/mlp.cu) runs the forward of the tiled MLP core,
the routine K3 and K4's fields pass share, on the persistent walk of
kernels/walk.py. It takes any grid: there is no nx % 128 gate and no
staged fallback. Its one limit is the shared memory of a block (W2 and a
chunk's CD rows), which grows with H: `mlp_fits` holds for H <= 3632 on an
H100, and a wider CUDA MLP raises. The 3-slice entry points are
differentiable in the params and t: an autograd.Function whose backward
is autograd through the staged models.fields.generate_fields (the JAX
custom_vjps, pallas/mlp.py:394-459 and :481-537).

Tiers (_build.TIERS): "f32" and "f32_high" run the f32 kernel; "bf16"
rounds a1 and W2 to bf16 and sums in float32, "bf16x3" adds hi.hi + lo.hi
+ hi.lo of their bf16 splits (pallas/mlp.py:231-235, 300-323), both on the
tensor cores (csrc/mlp_mma.cuh; H <= 2416 and 2064) with plain versions
here (`layer2`); the gradient stays the staged float32 autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.residuals import loss_forward_fused_packed, pack_fields
from phys_autodiff_tpu_torch.kernels.walk import num_blocks
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.coords import _axis_coord, time_offset
from phys_autodiff_tpu_torch.models.fields import generate_fields, slice_times
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

#: Rows of a chunk at S = 3 and at S = 1 slices (csrc/mlp.cu ZF_OF).
ZROWS = {3: 4, 1: 8}
#: Shared memory a block may use on an H100 (bytes), and a block's share
#: of an SM with two blocks on it (static included).
SMEM_LIMIT = 232448
TWO_BLOCKS = 115712
#: The bf16 forward's AB rings (csrc/mlp_mma.cuh): a stage is 16
#: hidden-unit planes of FW_PS floats (16 cells and 4 of padding), a warp
#: streams FW_NS stages, a block has 8 warps; FW_STATIC bytes of static
#: shared memory hold the warps' ring descriptors and the channel map.
FW_PS, FW_NS, WARPS, FW_STATIC = 20, 2, 8, 372


def ring_bytes(ns: int) -> int:
    """Shared memory of a block's AB rings at depth ns (mlp_mma.cuh ring_bytes)."""
    return ns * WARPS * 16 * FW_PS * 4


def ring_stages(fixed: int, nx: int) -> int:
    """The depth of the bf16 forward's AB rings beside `fixed` bytes of
    dynamic shared memory and FW_STATIC static ones (mlp_mma.cuh
    ring_stages): FW_NS where the rings fit without costing a block its
    second slot on an SM (or, where the rest alone keeps one block an SM,
    within that block's share); else
    0 (AB read from device memory at each k-step), as also where nx % 4 !=
    0 (the rows' 16-byte copies)."""
    fixed += FW_STATIC
    cap = TWO_BLOCKS if fixed <= TWO_BLOCKS else SMEM_LIMIT
    return FW_NS if nx % 4 == 0 and fixed + ring_bytes(FW_NS) <= cap else 0


def fields_fixed_bytes(h: int, n_slices: int = 3, tier: str = "bf16") -> int:
    """The bf16 / bf16x3 kernel's shared memory beside its rings (csrc/mlp.cu
    fields_smem_bf16): W2's B fragments (16 B a hidden unit, twice for
    bf16x3) and the CD rows [HP][ZROWS + 1][P] (P = 4 at S = 3, 1 at S = 1;
    one padding row against bank conflicts), HP = h padded to 16."""
    p = 4 if n_slices == 3 else 1
    return ((h + 15) & ~15) * (16 * (2 if tier == "bf16x3" else 1) + 4 * (ZROWS[n_slices] + 1) * p)


def smem_bytes(h: int, n_slices: int = 3, tier: str = "f32") -> int:
    """Shared memory of the kernel at hidden width h. f32: W2 [HP] float4
    and the chunk's CD rows [HP][ZROWS][S], HP = h padded to a multiple of
    4. bf16 / bf16x3: fields_fixed_bytes, the warps' AB rings at the depth
    that rows of 16-byte copies take (ring_stages; at nx % 4 != 0 a block
    takes less) and FW_STATIC static bytes."""
    if tier == "f32":
        return 4 * ((h + 3) & ~3) * (4 + ZROWS[n_slices] * n_slices)
    fixed = fields_fixed_bytes(h, n_slices, tier)
    return fixed + FW_STATIC + ring_bytes(ring_stages(fixed, nx=4))


def mlp_fits(h: int, tier: str = "f32") -> bool:
    """The kernel of `tier` takes hidden width h at both slice counts
    (H <= 3632 in f32, 2416 in bf16, 2064 in bf16x3)."""
    return h >= 1 and smem_bytes(h, 3, tier) <= SMEM_LIMIT


def _check_gate(h: int, tier: str = "f32") -> None:
    if not mlp_fits(h, tier):
        raise ValueError(
            f"{'K2' if tier == 'f32' else f'K2 ({tier})'}: H={h} needs {smem_bytes(h, 3, tier)} B of shared "
            f"memory a block; the fused "
            f"MLP kernel fits up to {SMEM_LIMIT} B (H <= {_build.gate_top(lambda x: mlp_fits(x, tier))})"
        )


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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


class _Layer2Bf16(torch.autograd.Function):
    """y [M, 4] = bf16(a1 [M, H]) bf16(W2T [4, H])^T with float32 sums: layer 2
    of the TPU's bf16 tier (pallas/mlp.py:231-232, mega.py:155-170,
    fit.py:128-135). Its backward rounds as the kernels' contractions do
    (pallas/fit.py:155-190, mega_bwd.py:705-750 on the TPU):
    dW2T = bf16(gy)^T bf16(a1) and da1 = bf16(gy) bf16(W2T), summed in
    float32. (Autograd through .to(torch.bfloat16) is straight-through: it
    would pass gy on unrounded.)"""

    @staticmethod
    def forward(ctx, a1, w2t):
        a, w = _bf16(a1), _bf16(w2t)
        ctx.save_for_backward(a, w)
        return a @ w.T

    @staticmethod
    def backward(ctx, gy):
        a, w = ctx.saved_tensors
        gb = _bf16(gy)
        return gb @ w, gb.T @ a


def _layer2_bf16x3(a1, w2t):
    """K2's bf16x3 layer 2 (pallas/mlp.py:233-235, 300-316): W2 and a1 split
    into bf16 hi + lo parts, hi.hi + hi.lo + lo.hi in float32. Forward only:
    K2's gradient is the staged autograd."""
    w_hi = _bf16(w2t)
    w_lo = _bf16(w2t - w_hi)
    a_hi = _bf16(a1)
    a_lo = _bf16(a1 - a_hi)
    return (a_hi @ w_hi.T + a_lo @ w_hi.T) + a_hi @ w_lo.T


def layer2(a1, w2t, tier: str, hdim: int):
    """sum_h W2T[o, h] a1[..., h, ...] in the arithmetic of `tier` ("bf16" or
    "bf16x3"): the hidden axis hdim of a1 becomes the 4 outputs."""
    a = torch.movedim(a1, hdim, -1)
    lead = a.shape[:-1]
    a = a.reshape(-1, a.shape[-1])
    y = _Layer2Bf16.apply(a, w2t) if tier == "bf16" else _layer2_bf16x3(a, w2t)
    return torch.movedim(y.reshape(*lead, 4), -1, hdim)


def mlp_tables_plain(ab, cd, w2t, b2, tier: str = "f32"):
    """The plain version of the kernel: y = W2^T relu(AB + CD) + b2, layer 2
    in the arithmetic of `tier` ("f32", "bf16" or "bf16x3"; layer 1 is
    float32 in every tier). Returns sigma [S, nz, ny, nx] and
    u [S, 3, nz, ny, nx]."""
    z1 = ab[None, None] + cd.permute(2, 0, 1)[:, :, :, None, None]  # [S, nz, H, ny, nx]
    a1 = torch.clamp_min(z1, 0.0)
    if tier == "f32":
        y = torch.einsum("oh,snhyx->snoyx", w2t, a1)
    else:
        y = layer2(a1, w2t, tier, 2)
    y = y + b2[None, None, :, None, None]
    return y[:, :, 0], y[:, :, 1:4].transpose(1, 2)


def check_dims(cfg: MLPGridConfig, params: mlp.Params) -> None:
    if cfg.dims.In != 4 or cfg.dims.Out != 4:
        raise ValueError("the fused MLP takes In = Out = 4")
    h = params["W1"].shape[1]
    _build.check_shape(params["W1"], (4, h), "W1")
    _build.check_shape(params["b1"], (h,), "b1")
    _build.check_shape(params["W2"], (h, 4), "W2")
    _build.check_shape(params["b2"], (4,), "b2")


def _launch(g: GridSpec, ab, cd, w2t, b2, sigma_out, u_out, tier: str = "f32") -> None:
    """One launch writing S slices: sigma channel s at sigma_out + s*N,
    u channel c of slice s at u_out + (3s + c)*N (N = nz*ny*nx). tier "f32"
    runs the f32 kernel, "bf16" and "bf16x3" the tensor-core one."""
    h, s = cd.shape[1], cd.shape[2]
    _check_gate(h, tier)
    dev = ab.device
    args = (ab.data_ptr(), cd.data_ptr(), w2t.data_ptr(), b2.data_ptr(), sigma_out.data_ptr(),
            u_out.data_ptr(), g.nx, g.ny, g.nz, h, s, num_blocks(g))
    with torch.cuda.device(dev):
        if tier == "f32":
            err = _build.lib().pat_mlp_fields(*args, _build.stream_ptr(dev))
        else:
            err = _build.lib().pat_mlp_fields_bf16(*args, int(tier == "bf16x3"), _build.stream_ptr(dev))
    _build.check(err, f"mlp kernel ({tier})", "K2", (sigma_out, u_out))
    _build.LAUNCHES["mlp" if tier == "f32" else f"mlp {tier}"] += 1


def _fields(g, cfg, params, ts, precision, packed: bool):
    """S-slice fields: (sigma [S,...], u [S,3,...]) or packed [4S, ...]."""
    tier = _build.check_precision(precision, "K2")
    check_dims(cfg, params)
    tables = fold_tables(g, cfg, params, ts)
    if not _build.uses_kernel(*params.values()):
        sigma, u = mlp_tables_plain(*tables, tier)
        if packed:
            return torch.cat([sigma, u.reshape((-1,) + g.shape)], dim=0)
        return sigma, u
    n_s, dev = len(ts), params["W1"].device
    if packed:
        out = torch.empty((4 * n_s,) + g.shape, dtype=torch.float32, device=dev)
        _launch(g, *tables, out, out[n_s:], tier)
        return out
    sigma = torch.empty((n_s,) + g.shape, dtype=torch.float32, device=dev)
    u = torch.empty((n_s, 3) + g.shape, dtype=torch.float32, device=dev)
    _launch(g, *tables, sigma, u, tier)
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
    differentiable by composition of the two autograd Functions. K1 reads
    the float32 fields whatever K2's tier (pallas/mlp.py:625-627)."""
    packed = generate_fields_fused_packed(g, cfg, params, t, precision)
    return loss_forward_fused_packed(g, w, packed, "f32")

