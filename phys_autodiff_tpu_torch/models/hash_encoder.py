"""Multiresolution hash encoding, Instant-NGP style (port of
phys_autodiff_tpu/models/hash_encoder.py).

L resolution levels, each a table of T entries x F features; a 3D
coordinate in [0, 1] is scaled to the level resolution, its 8 surrounding
lattice corners are hashed into the table (xor of per-dimension primes,
mod T) and the gathered features are interpolated trilinearly; the levels
concatenate into the encoding [..., L*F].

With `dense_oversubscribed=True`, a level whose corner lattice (r+1)^3
exceeds the table is stored densely as a [r+1, r+1, r+1, F] parameter grid.
On a regular grid every level's interpolation is three separable
contractions of its corner lattice with a static resampling matrix, whose
backward (autograd) is the transposed matmul, with no scatter. Hashed
levels gather their corner lattice once with static indices; the gather's
backward sums each table entry's corners through a static inverse table
(_CornerGather), so the pull-back has no atomics and gives the same bits
every run on the card.

Parameters: all-hash configs hold one [L, T, F] tensor; configs with dense
levels hold {"hash": [n_hash, T, F], "dense": {"l<level>": [r+1]*3 + [F]}}.
`init_hash_params` draws the same numpy MT19937 stream as the JAX package,
so one seed gives bitwise-equal tables in both packages. These are plain
PyTorch ops, as they were plain XLA ops (not Pallas) in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# Per-dimension hashing primes from the Instant-NGP paper; dim 0 is left
# unmultiplied (prime 1) like the original.
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    num_levels: int = 8  # L
    features_per_level: int = 2  # F
    log2_table_size: int = 14  # T = 2^14 entries per level
    base_resolution: int = 4  # N_min
    max_resolution: int = 128  # N_max (sets the growth factor)
    # Store oversubscribed levels ((r+1)^3 > T) as dense corner-lattice
    # parameter grids instead of hashed tables (module docstring).
    dense_oversubscribed: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def level_is_dense(self, level: int) -> bool:
        if not self.dense_oversubscribed:
            return False
        r = int(self.level_resolutions()[level])
        return (r + 1) ** 3 > self.table_size

    def dense_levels(self) -> list:
        return [l for l in range(self.num_levels) if self.level_is_dense(l)]

    def hash_levels(self) -> list:
        return [l for l in range(self.num_levels) if not self.level_is_dense(l)]

    def level_resolutions(self) -> np.ndarray:
        """Geometric schedule N_l = round(N_min * b^l), rounded so that
        max_resolution is reached."""
        if self.num_levels == 1:
            return np.asarray([self.base_resolution])
        ln = np.linspace(np.log(self.base_resolution), np.log(self.max_resolution), self.num_levels)
        return np.floor(np.exp(ln) + 0.5).astype(np.int64)


def init_hash_params(cfg: HashEncodingConfig, seed: int = 0, scale: float = 1e-4, device="cuda"):
    """Uniform(-scale, scale) init (the paper's), on `device`: the [L, T, F]
    tensor, or the dict of hashed and dense levels (module docstring)."""
    rng = np.random.Generator(np.random.MT19937(seed))
    dense_lvls = cfg.dense_levels()
    hash_arr = rng.uniform(
        -scale, scale, size=(cfg.num_levels - len(dense_lvls), cfg.table_size, cfg.features_per_level)
    ).astype(np.float32)
    hash_t = torch.tensor(hash_arr, device=device)
    if not dense_lvls:
        return hash_t
    res = cfg.level_resolutions()
    dense = {
        f"l{l}": torch.tensor(
            rng.uniform(-scale, scale, size=(int(res[l]) + 1,) * 3 + (cfg.features_per_level,)).astype(
                np.float32
            ),
            device=device,
        )
        for l in dense_lvls
    }
    return {"hash": hash_t, "dense": dense}


def schedule_meta(cfg: HashEncodingConfig) -> dict:
    """JSON-safe fingerprint of the encoding schedule, embedded in
    checkpoints so that tables restored into another schedule are refused
    rather than decoded into other fields."""
    return {
        "resolutions": [int(r) for r in cfg.level_resolutions()],
        "dense_levels": cfg.dense_levels(),
        "table_size": cfg.table_size,
        "features_per_level": cfg.features_per_level,
    }


def _tables_view(cfg: HashEncodingConfig, tables):
    """(hash_tables [n_hash, T, F], {level: dense grid}) from either the
    all-hash tensor or the dict structure."""
    if isinstance(tables, dict):
        dense = {int(k[1:]): v for k, v in tables["dense"].items()}
        return tables["hash"], dense
    if cfg.dense_levels():
        raise TypeError(
            "config has dense levels but `tables` is a plain tensor: "
            "initialize with init_hash_params(cfg) to get the dict structure"
        )
    return tables, {}


def _hash_corner(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of integer corner coordinates -> table index: the JAX
    package's uint32 xor of per-dimension products, mod the table size (a
    power of two). Computed in int64: the low 32 bits of each product, and
    so the masked index, are those of the uint32 arithmetic."""
    ix, iy, iz = ix.long(), iy.long(), iz.long()
    h = (ix * _PRIMES[0]) ^ (iy * _PRIMES[1]) ^ (iz * _PRIMES[2])
    return h & (table_size - 1)


# The pointwise encoder gathers 8 corners per point and level; grid-scale
# batches go through encode_grid (one static gather per level). The guard
# keeps the JAX package's contract.
MAX_POINTWISE_POINTS = 1 << 18


def encode(cfg: HashEncodingConfig, tables, coords: torch.Tensor, *, allow_large: bool = False):
    """Encode 3D coordinates in [0, 1]: coords [..., 3] -> [..., L*F].
    Differentiable in `tables` (and in `coords` through the weights).
    Raises above MAX_POINTWISE_POINTS points unless allow_large=True."""
    batch_shape = coords.shape[:-1]
    x = coords.reshape(-1, 3)
    n = x.shape[0]
    if n > MAX_POINTWISE_POINTS and not allow_large:
        raise ValueError(
            f"encode() called on {n} points (> {MAX_POINTWISE_POINTS}): use encode_grid for "
            "regular grids, or pass allow_large=True to override"
        )
    res_all = cfg.level_resolutions()
    hash_tables, dense = _tables_view(cfg, tables)
    hash_lvls = cfg.hash_levels()

    per_level = [None] * cfg.num_levels
    if hash_lvls:
        res = torch.tensor(res_all[hash_lvls], dtype=torch.float32, device=x.device)  # [Lh]
        xs = x[None, :, :] * (res[:, None, None] - 1.0)  # [Lh, N, 3]
        x0f = torch.floor(xs)
        frac = xs - x0f
        x0 = x0f.to(torch.int32)
        feats = 0
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            idx = _hash_corner(x0[..., 0] + dx, x0[..., 1] + dy, x0[..., 2] + dz, cfg.table_size)
            f = torch.gather(hash_tables, 1, idx[:, :, None].expand(-1, -1, cfg.features_per_level))
            wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
            feats = feats + f * (wx * wy * wz)[:, :, None]
        for i, l in enumerate(hash_lvls):
            per_level[l] = feats[i]
    for l, grid in dense.items():
        per_level[l] = _encode_dense_pointwise(grid, int(res_all[l]), x)
    out = torch.cat(per_level, dim=-1)
    return out.reshape(*batch_shape, cfg.out_dim)


def _encode_dense_pointwise(grid: torch.Tensor, r: int, x: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a dense [r+1, r+1, r+1, F] corner lattice
    at points x [N, 3] in [0, 1] -> [N, F]."""
    flat = grid.reshape(-1, grid.shape[-1])
    xs = x * float(np.float32(r - 1))
    x0f = torch.floor(xs)
    frac = xs - x0f
    x0 = x0f.to(torch.int64)
    out = 0
    for corner in range(8):
        dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
        idx = ((x0[:, 2] + dz) * (r + 1) + (x0[:, 1] + dy)) * (r + 1) + (x0[:, 0] + dx)
        f = flat[idx]
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
        wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
        out = out + f * (wx * wy * wz)[:, None]
    return out


def _resample_matrix(n: int, r: int) -> np.ndarray:
    """Static [r+1, n] linear-interpolation matrix taking r+1 corner samples
    to n grid samples (two nonzeros per column, 1-w at idx0 and w at
    idx0+1, built in float64). n == 1 selects sample 0."""
    m = np.zeros((r + 1, n), np.float32)
    if n == 1:
        m[0, 0] = 1.0
        return m
    pos = np.arange(n, dtype=np.float64) / (n - 1) * (r - 1)
    i0 = np.floor(pos).astype(np.int64)
    w = pos - i0
    cols = np.arange(n)
    m[i0, cols] += (1.0 - w).astype(np.float32)
    m[i0 + 1, cols] += w.astype(np.float32)
    return m


@functools.lru_cache(maxsize=256)
def _resample_matrix_on(n: int, r: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(_resample_matrix(n, r), device=device)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


class _ResampleBf16(torch.autograd.Function):
    """out = bf16(grid) . bf16(m) contracted over `axis` of grid (the new
    axis last) with float32 sums, and its pull-back the transposed matmul on
    rounded operands, bf16(d_out) . bf16(m)^T: one bf16 pass each way, what
    Precision.DEFAULT runs on the TPU's matrix unit in both directions. The
    products of bf16 values are exact in float32, so a float32 matmul (TF32
    off, PyTorch's default) gives the float32 sums on any device."""

    @staticmethod
    def forward(ctx, grid, m, axis):
        mb = _bf16(m)
        ctx.save_for_backward(mb)
        ctx.axis = axis
        return torch.tensordot(_bf16(grid), mb, dims=([axis], [0]))

    @staticmethod
    def backward(ctx, d_out):
        (mb,) = ctx.saved_tensors
        d = torch.tensordot(_bf16(d_out), mb, dims=([d_out.dim() - 1], [1]))
        return torch.movedim(d, -1, ctx.axis), None, None


def _axis_lerp_dense(grid: torch.Tensor, n: int, r: int, axis: int, fast: bool = False) -> torch.Tensor:
    """Linearly resample `grid` from r+1 samples to n along `axis`: a
    contraction with the static resampling matrix, whose backward is the
    transposed matmul (no scatter, so the same bits every run). On the card
    it runs in full float32: callers keep TF32 off (PyTorch's default for
    matmuls). fast=True rounds both operands to bf16 and sums in float32,
    forward and pull-back (_ResampleBf16)."""
    m = _resample_matrix_on(n, r, grid.device)
    out = _ResampleBf16.apply(grid, m, axis) if fast else torch.tensordot(grid, m, dims=([axis], [0]))
    return torch.movedim(out, -1, axis)


class _LerpZRows(torch.autograd.Function):
    """The z contraction of a level's corner lattice [r+1, F, y, x] with the
    whole grid's z resampling matrix m [r+1, nz], then the given rows of it
    -> [F, y, x, K]: the same matmul as encode_grid_zcf's, so every row has
    that encode's bits on any device (a matmul's sum order may depend on its
    shape: a narrower one, of the rows' columns alone, gave other bits on
    some CPUs' GEMM kernels). The pull-back is the transposed matmul of the
    rows' columns, as before (no scatter, the same bits every run)."""

    @staticmethod
    def forward(ctx, corner, m, rows):
        mz = m[:, rows]
        ctx.save_for_backward(mz)
        return torch.tensordot(corner, m, dims=([0], [0]))[..., rows]

    @staticmethod
    def backward(ctx, d_out):
        (mz,) = ctx.saved_tensors
        return torch.movedim(torch.tensordot(d_out, mz, dims=([d_out.dim() - 1], [1])), -1, 0), None, None


@functools.lru_cache(maxsize=64)
def _corner_hash_index(r: int, table_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Static hash indices of the full (r+1)^3 corner lattice of a level,
    [z, y, x] flattened (index r is reached with weight 0 at the top edge,
    as in the pointwise encoder), and their inverse table [T, K]: row e
    lists the corners that hash to entry e in ascending order, padded with
    the index (r+1)^3 (a zero row in the backward); K is the most corners
    any entry takes."""
    ii = np.arange(r + 1, dtype=np.uint32)
    hx = ii * np.uint32(_PRIMES[0])
    hy = ii * np.uint32(_PRIMES[1])
    hz = ii * np.uint32(_PRIMES[2])
    h = hz[:, None, None] ^ hy[None, :, None] ^ hx[None, None, :]
    idx = (h & np.uint32(table_size - 1)).astype(np.int64).ravel()
    n = idx.size
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=table_size)
    rank = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
    inv = np.full((table_size, max(int(counts.max()), 1)), n, np.int64)
    inv[idx[order], rank] = order
    return torch.tensor(idx, device=device), torch.tensor(inv, device=device)


class _CornerGather(torch.autograd.Function):
    """table[idx] whose backward gathers instead of scattering: entry e of
    the table's gradient is the sum of the corner cotangents listed in row e
    of the inverse table. index_add's CUDA kernel adds with atomics, in
    another order every run; torch's sum over a dimension uses none, so
    this sum has one order and the pull-back gives the same bits every
    run."""

    @staticmethod
    def forward(ctx, table, idx, inv):
        ctx.save_for_backward(inv)
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return padded[inv].sum(dim=1), None, None


def _hashed_corners(cfg: HashEncodingConfig, table: torch.Tensor, r: int) -> torch.Tensor:
    """The [r+1, r+1, r+1, F] corner lattice of a hashed level: one gather
    with static indices (_CornerGather: its backward is a fixed-order
    gather-sum into the table)."""
    idx, inv = _corner_hash_index(r, cfg.table_size, table.device)
    return _CornerGather.apply(table, idx, inv).reshape(r + 1, r + 1, r + 1, cfg.features_per_level)


def encode_grid_zcf(cfg: HashEncodingConfig, tables, g, fast: bool = False) -> torch.Tensor:
    """encode_grid in the z-major channel-first layout [nz, L*F, ny, nx]
    that the NGP backward mega-kernel reads. Each level's corner lattice is
    moved to [z, F, y, x] first (lattice-sized), then resampled along
    z, y, x; levels concatenate on the feature axis. Equal to encode_grid
    up to summation order.

    fast=True is the encode of the bf16-tier kernels (JAX's
    encode_grid_zcf(precision=DEFAULT), hash_encoder.py:325-347): the three
    resampling matmuls and their pull-back take bf16-rounded operands (the
    corner values and the resampling matrix) with float32 sums, which is
    what DEFAULT precision runs on the TPU; the corner gather-sum stays
    exact. JAX's CPU backend runs DEFAULT as HIGHEST, so on the CPU this
    differs from the JAX package's fast encode by the bf16 class (the
    tier's 5e-2 contract holds against either)."""
    nz, ny, nx = g.shape
    hash_tables, dense = _tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = torch.movedim(dense[lvl], -1, 1)  # [z, F, y, x]
        else:
            corner = torch.movedim(_hashed_corners(cfg, hash_tables[hash_pos[lvl]], r), -1, 1)
        lev = _axis_lerp_dense(corner, nz, r, 0, fast)
        lev = _axis_lerp_dense(lev, ny, r, 2, fast)
        lev = _axis_lerp_dense(lev, nx, r, 3, fast)
        outs.append(lev)
    return torch.cat(outs, dim=1)


def encode_grid_zcf_rows(cfg: HashEncodingConfig, tables, g, rows: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """encode_grid_zcf restricted to the given global z rows (an integer
    tensor, e.g. a shard's rows and its halo rows, wrapped or clamped) ->
    [len(rows), L*F, ny, nx]. The z resample is separable, so a row subset
    needs only the matching columns of the static z interpolation matrix;
    each produced row is the matching encode_grid_zcf row, bit for bit
    (_LerpZRows: the float32 z contraction runs at the whole grid's shape
    and keeps the rows; the fast one's bf16 products are exact), and the
    pull-back stays a transposed matmul. fast=True as in encode_grid_zcf."""
    nz, ny, nx = g.shape
    hash_tables, dense = _tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = torch.movedim(dense[lvl], -1, 1)  # [z, F, y, x]
        else:
            corner = torch.movedim(_hashed_corners(cfg, hash_tables[hash_pos[lvl]], r), -1, 1)
        m, rows_d = _resample_matrix_on(nz, r, corner.device), rows.to(corner.device)
        if fast:  # bf16 products are exact in float32: the rows' columns [r+1, K] give the same bits
            lev = _ResampleBf16.apply(corner, m[:, rows_d], 0)
        else:
            lev = _LerpZRows.apply(corner, m, rows_d)
        lev = torch.movedim(lev, -1, 0)  # [K, F, y, x]
        lev = _axis_lerp_dense(lev, ny, r, 2, fast)
        lev = _axis_lerp_dense(lev, nx, r, 3, fast)
        outs.append(lev)
    return torch.cat(outs, dim=1)


def encode_grid(cfg: HashEncodingConfig, tables, g) -> torch.Tensor:
    """Encode every point of a regular grid (coords v/(n-1) per axis) ->
    [nz, ny, nx, L*F]: the trilinear encoding of `encode` on the grid's
    coordinates, with the corner lattice gathered once per level and the
    interpolation as three separable resamples (weights in float64, so this
    path is the more accurate of the two, by about R * eps_f32 a level)."""
    nz, ny, nx = g.shape
    hash_tables, dense = _tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        corner = dense[lvl] if lvl in dense else _hashed_corners(cfg, hash_tables[hash_pos[lvl]], r)
        lev = _axis_lerp_dense(corner, nz, r, 0)
        lev = _axis_lerp_dense(lev, ny, r, 1)
        lev = _axis_lerp_dense(lev, nx, r, 2)
        outs.append(lev)
    return torch.cat(outs, dim=-1)
