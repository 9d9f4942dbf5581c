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

encode_grid_zcf and encode_grid_zcf_rows, the NGP kernels' encoder, take
these plain ops for CPU tensors (encode_grid_zcf_plain,
encode_grid_zcf_rows_plain) and, for CUDA tensors, csrc/hash_encode.cu:
one launch for every level's lerps straight into the [rows, L*F, ny, nx]
layout, and a pull-back of two fixed-order gathers (_EncodeKernel), from
tap and CSR tables that the host reads off the same resampling matrices
(_plan_arrays). The corner gather of the hashed levels stays in PyTorch.

Parameters: all-hash configs hold one [L, T, F] tensor; configs with dense
levels hold {"hash": [n_hash, T, F], "dense": {"l<level>": [r+1]*3 + [F]}}.
`init_hash_params` draws the same numpy MT19937 stream as the JAX package,
so one seed gives bitwise-equal tables in both packages. These are plain
PyTorch ops, as they were plain XLA ops (not Pallas) in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.timing import annotate

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
    that the NGP backward mega-kernel reads: each level's corner lattice
    resampled along z, then y, then x, the levels on the feature axis. Equal
    to encode_grid up to summation order. CPU tables take the plain ops
    (encode_grid_zcf_plain), CUDA tables the kernel pair of
    csrc/hash_encode.cu (_EncodeKernel), whose values are the plain ops'
    up to the matmuls' accumulation order and whose pull-back gives the same
    bits every run.

    fast=True is the encode of the bf16-tier kernels (JAX's
    encode_grid_zcf(precision=DEFAULT), hash_encoder.py:325-347): the three
    resampling matmuls and their pull-back take bf16-rounded operands (the
    corner values and the resampling matrix) with float32 sums, which is
    what DEFAULT precision runs on the TPU; the corner gather-sum stays
    exact. JAX's CPU backend runs DEFAULT as HIGHEST, so on the CPU this
    differs from the JAX package's fast encode by the bf16 class (the
    tier's 5e-2 contract holds against either)."""
    with annotate("pat.encode"):
        if _on_card(cfg, tables):
            return _encode_on_card(cfg, tables, g, None, fast)
        return encode_grid_zcf_plain(cfg, tables, g, fast)


def encode_grid_zcf_plain(cfg: HashEncodingConfig, tables, g, fast: bool = False) -> torch.Tensor:
    """encode_grid_zcf by plain ops on any device: each level's corner
    lattice moved to [z, F, y, x] (lattice-sized), resampled along z, y, x
    by the dense matmuls (_axis_lerp_dense), the levels concatenated."""
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
    [len(rows), L*F, ny, nx], each row the matching encode_grid_zcf row,
    bit for bit, on either path: CPU tables take the plain ops
    (encode_grid_zcf_rows_plain), CUDA tables the kernel pair with the rows'
    z taps (the whole grid is the list of all rows). fast=True as in
    encode_grid_zcf."""
    if _on_card(cfg, tables):
        return _encode_on_card(cfg, tables, g, rows, fast)
    return encode_grid_zcf_rows_plain(cfg, tables, g, rows, fast)


def encode_grid_zcf_rows_plain(cfg: HashEncodingConfig, tables, g, rows: torch.Tensor,
                               fast: bool = False) -> torch.Tensor:
    """encode_grid_zcf_rows by plain ops on any device. The z resample is
    separable, so a row subset needs only the matching columns of the
    static z interpolation matrix; each produced row is the matching
    encode_grid_zcf_plain row, bit for bit (_LerpZRows: the float32 z
    contraction runs at the whole grid's shape and keeps the rows; the fast
    one's bf16 products are exact), and the pull-back stays a transposed
    matmul."""
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


# ---------------------------------------------------------------------------
# The grid encoder on the card: csrc/hash_encode.cu
# ---------------------------------------------------------------------------

_MAX_LEVELS = 64  # csrc/hash_encode.cu MAX_LEVELS
_STAGE_STRIDE = 10  # csrc/hash_encode.cu SDS: a staged dEnc column's stride in shared memory
_Q_STRIDE = 9  # csrc/hash_encode.cu CS: Q's
_CHUNK = 8  # csrc/hash_encode.cu CHUNK: the dEnc rows pass A stages at a time
_TILE_POINTS = 2048  # the most lattice points (i, j) a pass-A block accumulates (in shared memory)
_ROWS_A = 2  # the dEnc rows k a pass-A block takes (2 and 4 beat 8 and 16 on the card)
_TILE_ROWS = 64  # the most dEnc rows a pass-A block reads, unless one lattice row reads more
_Z_TERMS = 64  # the most plane terms a pass-B thread sums, unless one lattice plane has more
_SMEM_MAX = 227 * 1024  # shared memory a block may take on the card
_INT_MAX = 2**31 - 1


def _axis_tables(m: np.ndarray, fast: bool = False):
    """The kernels' tables of one axis's resampling matrix m [r+1, n] (or
    its columns m[:, rows]): per column o, i0[o] (its first nonzero row) and
    w[o] = (m[i0, o], m[i0 + 1, o]), the forward's two taps; per row j, the
    CSR list of its nonzero columns in ascending order (indptr [r+2], idx,
    wts), the pull-back's gather. fast=True rounds every weight to bf16 (the
    matrix _ResampleBf16 multiplies by). Raises where a column's nonzeros
    are not rows i0 and i0 + 1 <= r, the only ones the kernels read."""
    if fast:
        m = _bf16(torch.from_numpy(m)).numpy()
    r1, n = m.shape
    cols = np.arange(n)
    i0 = np.argmax(m != 0, axis=0)
    if (i0 + 1 >= r1).any() or (m[i0, cols] == 0).any():
        raise ValueError("a resampling column without two lattice rows below the last")
    w = np.stack([m[i0, cols], m[i0 + 1, cols]], axis=1).astype(np.float32)
    taps = np.zeros_like(m)
    taps[i0, cols] = w[:, 0]
    taps[i0 + 1, cols] = w[:, 1]
    if not np.array_equal(taps, m):
        raise ValueError("a resampling column with nonzeros beyond two adjacent lattice rows")
    rr, cc = np.nonzero(m)  # row-major: rows ascending, each row's columns ascending
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rr, minlength=r1))])
    return i0.astype(np.int32), w, indptr.astype(np.int32), cc.astype(np.int32), m[rr, cc].astype(np.float32)


def _tiles_a(level: int, yp: np.ndarray, yidx: np.ndarray, r1: int) -> list:
    """Pass A's tiles of a level: runs of lattice rows [ia, ib) whose y
    lists span at most one chunk of dEnc rows where the lists are short (at
    most _CHUNK / 2 rows on average: a tile's rows then take one chunk a
    row k), else _TILE_ROWS (a lone lattice row may span more), and whose
    plane holds at most _TILE_POINTS points; each tile [level, ia, ib, y0,
    y1, 0, 0, 0] with [y0, y1) the rows its lists read."""
    limit = _CHUNK if len(yidx) * 2 <= r1 * _CHUNK else _TILE_ROWS
    tiles, i = [], 0
    while i < r1:
        ia, lo, hi = i, None, None
        while i < r1:
            ys = yidx[yp[i]:yp[i + 1]]
            nlo = lo if not len(ys) else (int(ys[0]) if lo is None else min(lo, int(ys[0])))
            nhi = hi if not len(ys) else (int(ys[-1]) if hi is None else max(hi, int(ys[-1])))
            span = 0 if nlo is None else nhi - nlo + 1
            if i > ia and (span > limit or (i + 1 - ia) * r1 > _TILE_POINTS):
                break
            lo, hi, i = nlo, nhi, i + 1
        y0 = 0 if lo is None else lo
        tiles.append([level, ia, i, y0, y0 if hi is None else hi + 1, 0, 0, 0])
    return tiles


def _tiles_b(level: int, zp: np.ndarray, r1: int) -> list:
    """Pass B's tiles of a level: 256 lattice points (i, j) of its plane by
    a run of lattice planes [iz0, iz1) whose z lists hold at most _Z_TERMS
    terms in all (a lone plane may hold more); each [level, e0, iz0, iz1]."""
    runs, iz = [], 0
    while iz < r1:
        iz0, terms = iz, 0
        while iz < r1 and (iz == iz0 or terms + zp[iz + 1] - zp[iz] <= _Z_TERMS):
            terms += int(zp[iz + 1] - zp[iz])
            iz += 1
        runs.append((iz0, iz))
    return [[level, e0, a, b] for e0 in range(0, r1 * r1, 256) for a, b in runs]


def _plan_arrays(res: tuple, nz: int, ny: int, nx: int, rows: tuple | None, fast: bool) -> dict:
    """The host tables of the kernel pair for levels of resolutions `res`
    (F = 2) on an nz x ny x nx grid, at the z rows `rows` (None: all).
    meta [L, 8]: r, the offsets of the level's x, y, z CSR row pointers in
    cptr, of its [r+1, r+1, 2] plane in a row of pass A's scratch
    (row_floats a row), of its gradient [r+1]^3 x 2 in the flat gradient
    (grad_floats); taps_i / taps_w: the forward taps (i0, and the two
    weights) of z [L, K], then y [L, ny], then x [L, nx]; cptr, cidx, cw:
    every level's x, y and z CSR lists; tiles_a [n, 8], tiles_b [n, 4]; and
    the launch sizes."""
    nlev, k = len(res), nz if rows is None else len(rows)
    meta = np.zeros((nlev, 8), np.int64)
    taps = {a: [] for a in "zyx"}
    cptr, cidx, cw, tiles_a, tiles_b = [], [], [], [], []
    n_ptr = n_idx = plane = grad = 0
    for lvl, r in enumerate(res):
        r1 = r + 1
        if r1 > _TILE_POINTS:
            raise ValueError(f"the hash encode kernel takes resolutions up to {_TILE_POINTS - 1}, got {r}")
        mz = _resample_matrix(nz, r)
        axes = {"x": _axis_tables(_resample_matrix(nx, r), fast), "y": _axis_tables(_resample_matrix(ny, r), fast),
                "z": _axis_tables(mz if rows is None else mz[:, list(rows)], fast)}
        for a in "xy":  # pass A reads a list as a run of columns from its first
            indptr, idx = axes[a][2], axes[a][3]
            counts = np.diff(indptr)
            first = np.repeat(idx[np.minimum(indptr[:-1], max(len(idx) - 1, 0))], counts) if len(idx) else idx
            if not np.array_equal(idx - first, np.arange(len(idx)) - np.repeat(indptr[:-1], counts)):
                raise ValueError(f"a lattice index whose {a} list is not a run of grid indices")
        meta[lvl, :] = [r, 0, 0, 0, plane, grad, 0, 0]
        for slot, a in ((1, "x"), (2, "y"), (3, "z")):
            i0, w, indptr, idx, wts = axes[a]
            taps[a].append((i0, w))
            meta[lvl, slot] = n_ptr
            cptr.append(indptr + n_idx)
            cidx.append(idx)
            cw.append(wts)
            n_ptr, n_idx = n_ptr + r1 + 1, n_idx + len(idx)
        tiles_a += _tiles_a(lvl, axes["y"][2], axes["y"][3], r1)
        tiles_b += _tiles_b(lvl, axes["z"][2], r1)
        plane, grad = plane + 2 * r1 * r1, grad + 2 * r1 ** 3
    if max(grad, n_idx, k * ny * nx) > _INT_MAX or k > 65535 or nlev > _MAX_LEVELS:
        raise ValueError(f"the hash encode kernel takes up to {_MAX_LEVELS} levels, 65535 rows and 2^31 - 1 "
                         f"gradient values (got {nlev} levels, {k} rows, {grad} values)")
    tiles_a = np.asarray(tiles_a, np.int32)
    r1max = max(res) + 1
    q = 2 * r1max * _Q_STRIDE
    points = max((t[2] - t[1]) * (res[t[0]] + 1) for t in tiles_a.tolist())
    smem_a = 4 * (2 * nx * _STAGE_STRIDE + q + q % 2) + 8 * points  # the staged chunk, Q, the tile's plane
    if smem_a > _SMEM_MAX:
        raise ValueError(f"the hash encode pull-back needs {smem_a} B of shared memory a block (nx = {nx})")
    return {
        "meta": meta.astype(np.int32),
        "taps_i": np.concatenate([i0 for a in "zyx" for i0, _ in taps[a]]),
        "taps_w": np.concatenate([w for a in "zyx" for _, w in taps[a]]),
        "cptr": np.concatenate(cptr).astype(np.int32),
        "cidx": np.concatenate(cidx),
        "cw": np.concatenate(cw),
        "tiles_a": tiles_a,
        "tiles_b": np.asarray(tiles_b, np.int32),
        "k": k, "row_floats": plane, "grad_floats": grad, "kb": _ROWS_A, "smem_a": smem_a,
    }


@dataclasses.dataclass(frozen=True)
class _Plan:
    """_plan_arrays' tables on the device, and the launch sizes."""

    levels: int
    k: int
    ny: int
    nx: int
    fast: bool
    device: torch.device
    tensors: dict
    sizes: dict
    res: tuple


@functools.lru_cache(maxsize=32)
def _plan(res: tuple, nz: int, ny: int, nx: int, rows: tuple | None, fast: bool, device: torch.device) -> _Plan:
    arrays = _plan_arrays(res, nz, ny, nx, rows, fast)
    tensors = {name: torch.tensor(arrays[name], device=device)
               for name in ("meta", "taps_i", "taps_w", "cptr", "cidx", "cw", "tiles_a", "tiles_b")}
    sizes = {name: arrays[name] for name in ("k", "row_floats", "grad_floats", "kb", "smem_a")}
    return _Plan(len(res), arrays["k"], ny, nx, fast, device, tensors, sizes, res)


def _launch_encode(plan: _Plan, corners) -> torch.Tensor:
    from phys_autodiff_tpu_torch.kernels import _build  # the kernels package imports this module

    t = plan.tensors
    out = torch.empty((plan.k, 2 * plan.levels, plan.ny, plan.nx), dtype=torch.float32, device=plan.device)
    ptrs = (ctypes.c_longlong * plan.levels)(*(c.data_ptr() for c in corners))
    with torch.cuda.device(plan.device):
        err = _build.lib().pat_hash_encode(
            ctypes.addressof(ptrs), plan.levels, t["meta"].data_ptr(), t["taps_i"].data_ptr(),
            t["taps_w"].data_ptr(), out.data_ptr(), plan.k, plan.ny, plan.nx, int(plan.fast),
            _build.stream_ptr(plan.device))
    _build.check(err, "hash encode kernel", "hash_encode", (out,))
    _build.LAUNCHES["hash_encode bf16" if plan.fast else "hash_encode"] += 1
    return out


def _launch_pullback(plan: _Plan, d_enc: torch.Tensor) -> list:
    """Each level's lattice gradient [r+1, r+1, r+1, 2] (views of one flat
    buffer) from d_enc [K, 2L, ny, nx]: pass A into a scratch plane a level
    and row, pass B over z."""
    from phys_autodiff_tpu_torch.kernels import _build

    t, n = plan.tensors, plan.sizes
    _build.check_shape(d_enc, (plan.k, 2 * plan.levels, plan.ny, plan.nx), "d_enc")
    d_enc = d_enc.contiguous()
    planes = torch.empty(plan.k * n["row_floats"], dtype=torch.float32, device=plan.device)
    grad = torch.empty(n["grad_floats"], dtype=torch.float32, device=plan.device)
    with torch.cuda.device(plan.device):
        err = _build.lib().pat_hash_encode_pullback(
            d_enc.data_ptr(), t["meta"].data_ptr(), t["taps_i"].data_ptr(), t["taps_w"].data_ptr(),
            t["tiles_a"].data_ptr(), t["tiles_a"].shape[0],
            t["tiles_b"].data_ptr(), t["tiles_b"].shape[0], t["cptr"].data_ptr(), t["cidx"].data_ptr(),
            t["cw"].data_ptr(), planes.data_ptr(), grad.data_ptr(), plan.k, plan.ny, plan.nx, plan.levels,
            n["row_floats"], n["kb"], n["smem_a"], int(plan.fast), _build.stream_ptr(plan.device))
    _build.check(err, "hash encode pull-back kernel", "hash_encode pullback", (grad,))
    _build.LAUNCHES["hash_encode bf16 pullback" if plan.fast else "hash_encode pullback"] += 1
    out, off = [], 0
    for r in plan.res:
        size = 2 * (r + 1) ** 3
        out.append(grad[off:off + size].view(r + 1, r + 1, r + 1, 2))
        off += size
    return out


class _EncodeKernel(torch.autograd.Function):
    """The grid encoding [K, 2L, ny, nx] of the levels' corner lattices
    (each [r+1, r+1, r+1, 2]: a dense level's parameter grid, a hashed
    level's _hashed_corners) by csrc/hash_encode.cu, one launch; its
    pull-back the kernel pair's two fixed-order gathers, one entry point,
    a lattice gradient for each level (a hashed level's goes on through
    _CornerGather's backward)."""

    @staticmethod
    def forward(ctx, plan, *corners):
        ctx.plan = plan
        return _launch_encode(plan, corners)

    @staticmethod
    def backward(ctx, d_enc):
        return (None, *_launch_pullback(ctx.plan, d_enc))


def _on_card(cfg: HashEncodingConfig, tables) -> bool:
    """False for CPU tables (the plain ops), True for CUDA ones (the
    kernels); raises for any other device."""
    dev = _tables_view(cfg, tables)[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no hash encoder for device {dev}")
    return dev.type == "cuda"


def _encode_on_card(cfg: HashEncodingConfig, tables, g, rows, fast: bool) -> torch.Tensor:
    """encode_grid_zcf (rows None) or encode_grid_zcf_rows through
    _EncodeKernel; raises on what the kernels do not take."""
    if cfg.features_per_level != 2:
        raise ValueError(f"the hash encode kernel takes 2 features a level, got {cfg.features_per_level}")
    hash_tables, dense = _tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    res = tuple(int(r) for r in cfg.level_resolutions())
    corners = [dense[l] if l in dense else _hashed_corners(cfg, hash_tables[hash_pos[l]], r) for l, r in enumerate(res)]
    for c, r in zip(corners, res):
        if c.device != hash_tables.device or c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("the hash encode kernel takes contiguous float32 tables on one device")
        if tuple(c.shape) != (r + 1,) * 3 + (2,):
            raise ValueError(f"corner lattice: expected shape {(r + 1,) * 3 + (2,)}, got {tuple(c.shape)}")
    key = None if rows is None else tuple(int(v) for v in rows.tolist())
    plan = _plan(res, g.nz, g.ny, g.nx, key, bool(fast), hash_tables.device)
    return _EncodeKernel.apply(plan, *corners)
