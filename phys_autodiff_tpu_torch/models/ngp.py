"""The encoded-field (NGP) model: an encoder family + a 2-layer decode head
(port of phys_autodiff_tpu/models/ngp.py).

(x, y, z) goes through the encoder (models/encoders.py: hash / dense tables
or Fourier features), the time channel is appended, and the head decodes
[sigma, ux, uy, uz]. It feeds the same FieldSnapshots / physics-loss
pipeline as the coordinate MLP and trains end to end by autograd (tables
and head together), or through the NGP backward mega-kernel K5
(kernels/mega_ngp.py).

Parameters: {"tables": the encoder's, "W1": [LF+1, H], "b1": [H],
"W2": [H, 4], "b2": [4]}, the JAX layout. `init_ngp_params` draws the same
numpy MT19937 streams as the JAX package (bitwise-equal params for one
seed); `params_from_jax` / `params_to_numpy` carry the nested tree across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.models.coords import _axis_coord
from phys_autodiff_tpu_torch.models.fields import slice_times
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.utils.config import CoordNorm, GridSpec


@dataclasses.dataclass(frozen=True)
class NGPFieldConfig:
    # Any models.encoders family. The default hash encoding stores
    # oversubscribed levels densely (models/hash_encoder.py): their backward
    # is a transposed matmul instead of a scatter into the tables.
    encoding: object = dataclasses.field(
        default_factory=lambda: HashEncodingConfig(dense_oversubscribed=True)
    )
    hidden: int = 64
    out: int = 4  # [sigma, ux, uy, uz]

    @property
    def head_in(self) -> int:
        return self.encoding.out_dim + 1  # + the time channel


#: The encoded-field tiers that ROADMAP.md Queue B, item B2 (part 2) has
#: still to port, by caller: the kernels K5 and K7, and the head of the
#: autograd path.
B2_TIERS = {
    "K5": "the bf16 and f32_fastbwd tiers of K5 and the fast hash encode",
    "K7": "the bf16 tier of K7 and the fast hash encode",
    "head": "the bf16 head and the fast hash encode",
}


def check_precision(precision: str, kernel: str = "head") -> None:
    """Only the float32 head is ported; the other tiers raise, naming the
    caller (a key of B2_TIERS: the kernel, or "head" for the autograd path)
    and its B2 tier."""
    if precision == "f32":
        return
    if precision in ("bf16", "f32_fastbwd"):
        who = "the encoded-field head" if kernel == "head" else kernel
        raise NotImplementedError(
            f"{who}: precision {precision!r} of the encoded-field model is not ported yet "
            f"(ROADMAP.md Queue B, item B2 part 2: {B2_TIERS[kernel]}); use precision='f32'"
        )
    raise ValueError(f"unknown precision {precision!r}")


def init_ngp_params(cfg: NGPFieldConfig, seed: int = 0, device="cuda") -> dict:
    """Encoder params from `seed`, head weights (Glorot-uniform) from
    seed + 1 and zero biases, on `device`."""
    rng = np.random.Generator(np.random.MT19937(seed + 1))
    lim1 = float(np.sqrt(6.0 / (cfg.head_in + cfg.hidden)))
    lim2 = float(np.sqrt(6.0 / (cfg.hidden + cfg.out)))
    w1 = rng.uniform(-lim1, lim1, (cfg.head_in, cfg.hidden)).astype(np.float32)
    w2 = rng.uniform(-lim2, lim2, (cfg.hidden, cfg.out)).astype(np.float32)
    return {
        "tables": encoders.init_params(cfg.encoding, seed=seed, device=device),
        "W1": torch.tensor(w1, device=device),
        "b1": torch.zeros((cfg.hidden,), dtype=torch.float32, device=device),
        "W2": torch.tensor(w2, device=device),
        "b2": torch.zeros((cfg.out,), dtype=torch.float32, device=device),
    }


def params_from_jax(tree, device="cuda"):
    """A JAX NGP params tree (numpy or array-like leaves, nested dicts) ->
    the same tree of contiguous float32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.tensor(np.ascontiguousarray(tree, dtype=np.float32), device=device)


def params_to_numpy(tree):
    """The inverse of params_from_jax: the same tree of numpy arrays (copies,
    which later in-place updates of the params leave as they are)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _f32(t):
    """t rounded to float32: a float for host values, a float32 tensor
    (which autograd follows) for a tensor."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return float(np.float32(t))


def _apply_head(params: dict, enc: torch.Tensor, t) -> torch.Tensor:
    """The decode head on an encoding [..., LF]: concat the time channel,
    relu(h @ W1 + b1) @ W2 + b2 (float32 matmuls)."""
    shape = enc.shape[:-1] + (1,)
    t_chan = _f32(t).expand(shape) if isinstance(t, torch.Tensor) else enc.new_full(shape, _f32(t))
    h = torch.cat([enc, t_chan], dim=-1)
    a1 = torch.clamp_min(torch.matmul(h, params["W1"]) + params["b1"], 0.0)
    return torch.matmul(a1, params["W2"]) + params["b2"]


def _head_base(params: dict, enc: torch.Tensor) -> torch.Tensor:
    """enc @ W1[:-1] + b1, the time-independent part of layer 1: time is
    the last input channel, so it enters only as the rank-1 term
    t * W1[-1], and one matmul serves all three time slices."""
    return torch.matmul(enc, params["W1"][:-1]) + params["b1"]


def _head_from_base(params: dict, base: torch.Tensor, t) -> torch.Tensor:
    """Finish the head at time t from the shared base -> [..., 4]."""
    a1 = torch.clamp_min(base + _f32(t) * params["W1"][-1], 0.0)
    return torch.matmul(a1, params["W2"]) + params["b2"]


def _head_from_base_cf(params: dict, base: torch.Tensor, t) -> torch.Tensor:
    """Channel-first head finish: [4, nz, ny, nx] from base [nz, ny, nx, H]."""
    a1 = torch.clamp_min(base + _f32(t) * params["W1"][-1], 0.0)
    out = torch.tensordot(params["W2"].T, a1, dims=([1], [3]))
    return out + params["b2"][:, None, None, None]


def forward(cfg: NGPFieldConfig, params: dict, coords: torch.Tensor, t, *, allow_large: bool = False):
    """coords [..., 3] in [0, 1], t a scalar -> [..., out] (the pointwise
    path; regular grids go through grid_infer / generate_fields)."""
    enc = encoders.encode(cfg.encoding, params["tables"], coords, allow_large=allow_large)
    return _apply_head(params, enc, t)


def checkpoint_meta(cfg: NGPFieldConfig) -> dict:
    """Metadata to embed in an NGP checkpoint (train.checkpoint.save_npz
    meta=...): restoring under another encoding schedule is refused."""
    return {"ngp_encoding": encoders.schedule_meta(cfg.encoding)}


def _unit_coords(g: GridSpec, device) -> torch.Tensor:
    """Spatial grid coordinates in [0, 1], [nz, ny, nx, 3]."""
    cx, cy, cz = (_axis_coord(n, CoordNorm.ZeroToOne, device) for n in (g.nx, g.ny, g.nz))
    shape = g.shape
    return torch.stack(
        [cx[None, None, :].expand(shape), cy[None, :, None].expand(shape), cz[:, None, None].expand(shape)],
        dim=-1,
    )


def grid_infer(g: GridSpec, cfg: NGPFieldConfig, params: dict, t) -> torch.Tensor:
    """[nz, ny, nx, out] at time t, through the regular-grid encoder."""
    return _apply_head(params, encoders.encode_grid(cfg.encoding, params["tables"], g), t)


def generate_fields_packed(
    g: GridSpec, cfg: NGPFieldConfig, params: dict, t, dt, precision: str = "f32"
) -> torch.Tensor:
    """Fields at (t-dt, t, t+dt) in the packed [12, nz, ny, nx] layout of
    the fused loss kernel (kernels/residuals.PACKED_ORDER): three sigma
    slices, then u_tm1, u_t, u_tp1 component-major."""
    check_precision(precision)
    base = _head_base(params, encoders.encode_grid(cfg.encoding, params["tables"], g))
    ys = [_head_from_base_cf(params, base, tt) for tt in slice_times(t, dt)]
    return torch.cat([ys[0][0:1], ys[1][0:1], ys[2][0:1], ys[0][1:4], ys[1][1:4], ys[2][1:4]], dim=0)


def generate_fields(g: GridSpec, cfg: NGPFieldConfig, params: dict, t, dt, precision: str = "f32") -> FieldSnapshots:
    """Fields at t-dt, t, t+dt; the encoding and the layer-1 base are
    computed once and shared by the three slices."""
    check_precision(precision)
    base = _head_base(params, encoders.encode_grid(cfg.encoding, params["tables"], g))
    ys = [_head_from_base(params, base, tt) for tt in slice_times(t, dt)]
    sigmas = [y[..., 0] for y in ys]
    us = [torch.movedim(y[..., 1:4], -1, -4) for y in ys]
    return FieldSnapshots(
        sigma_tm1=sigmas[0], sigma_t=sigmas[1], sigma_tp1=sigmas[2], u_tm1=us[0], u_t=us[1], u_tp1=us[2]
    )
