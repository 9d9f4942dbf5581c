// The tiled coordinate-MLP core, shared by K4 (mega_bwd.cu, S = 3 slices
// t-dt, t, t+dt) and K6 (fit.cu, S = 1 slice t), beside the NGP head core
// of ngp_head.cuh.
//
// The MLP is y_s = W2T relu(AB + CD[z, :, s]) + b2 per cell, from the
// folded tables AB [H, ny, nx] and CD [nz, H, S]. Given the cotangents gy_s
// of the outputs, the backward is dz1_s = [AB + CD_s > 0] (W2 gy_s) and
//   dAB[h, cell] = sum over z and s of dz1_s    (a sum over rows)
//   dCD[z, h, s] = sum over cells of dz1_s       (a sum over cells)
//   dW2T[:, h]   = sum over z, cells, s of relu(AB + CD_s) gy_s
// A block walks 32 x 8 tile rows (tile, z) in chunks of up to Z rows of one
// tile. Two thread maps, both with the 32 lanes of a warp on 32 cells of a
// tile row, so that every device-memory load and store of AB, the fields,
// the cotangents, the target and dAB moves whole 128-byte lines:
//   forward (in K4's fields pass and K6's phase A): thread per cell, over
//     the hidden units in order (one FMA chain per output, as the
//     thread-per-cell loops of K2 and K3), several rows at once with AB read
//     once for them and W2 and the CD rows as float4 broadcasts; the loop
//     over the rows is straight-line (a branch on the chunk's row count
//     inside the loop over hidden units cost K4's fields pass 30% on an
//     H100).
//   backward: a warp owns a pair of hidden units (HQ = 2) for the whole
//     tile: lane l holds the column x0 + l, all 8 rows y0..y0+7 of it, so a
//     register micro-tile of 8 cells x 2 hidden units. It loads AB for the
//     tile once a chunk, keeps W2's columns of its two hidden units in
//     registers as float4, and per row reads each cell's gy (S = 1: one
//     float4; S = 3: dF and g / 2dt) once for 16 (K6) or 32 (K4) FMAs,
//     two rows interleaved. dAB
//     sums over the chunk's rows in registers and, across the chunks of one
//     tile, in the block's own partial; dCD of the row sums over the lane's
//     cells in registers, then over the warp in a fixed shuffle tree
//     (warp_sum); dW2T likewise once a chunk, into shared memory the warp
//     alone writes.
// Loop order for dAB: hidden-unit pairs outer, the chunk's rows inner. The
// chunk's cotangents sit in shared memory (Z x 256 x 16 B, or x 32 B for
// S = 3), and dAB leaves the block once a (block, tile): the partial slot
// blk + tile (at most nblk + ntiles - 1 slots of H x 256 floats; 41 MB at
// 128x96x96, H = 128).
//
// Padding: H pads to HP = a multiple of 4 with zero weights, zero CD and
// zero AB, which add exact zeros; nothing past H is stored.
//
// Grid: persistent. The ntx * nty * nz tile rows are dealt in contiguous
// ranges (tile-major, z fastest) to min(rows, NBLK) blocks, NBLK = 264: two
// blocks on each of the H100's 132 SMs, one whole wave when two fit an SM.
// The block count is a constant, not the card's SM count, so every sum has
// one order on any card. Nothing is added with atomics: the sums passes
// (k_bwd_finalize, k_bwd_reduce) add the partials in a fixed order.

#pragma once

#include "stencil.cuh"

namespace {  // internal linkage: each kernel source has its own copy
namespace mlph {

constexpr int NT = pat::TILE_THREADS;  // cells of a tile row, threads of a block
constexpr int TX = pat::TILE_X;
constexpr int TY = pat::TILE_Y;
constexpr int NW = NT / 32;            // warps of a block
constexpr int HQ = 2;                  // hidden units of a backward item
constexpr int NBLK = 264;              // most blocks of the persistent grid
constexpr int SMEM_LIMIT = 232448;     // shared memory a block may use (dynamic + static)

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The block of the persistent walk that owns tile row r.
__host__ __device__ inline int block_of_row(int r, int nrows, int nblk) {
  return (int)(((long long)(r + 1) * nblk - 1) / nrows);
}

// The contiguous range [r0, r1) of tile rows of this block.
__device__ __forceinline__ void block_rows(int nrows, int& r0, int& r1) {
  r0 = (int)((long long)blockIdx.x * nrows / gridDim.x);
  r1 = (int)((long long)(blockIdx.x + 1) * nrows / gridDim.x);
}

// Up to Z consecutive rows of one tile, from tile row r of a block's range
// that ends at r1: the tile, its origin, the first z and the row count.
struct Chunk {
  int tile, x0, y0, z0, n;
};

__device__ __forceinline__ Chunk chunk_at(int r, int r1, int Z, int nz, int ntx) {
  Chunk c;
  c.tile = r / nz;
  c.z0 = r % nz;
  c.n = min(min(Z, nz - c.z0), r1 - r);
  c.x0 = (c.tile % ntx) * TX;
  c.y0 = (c.tile / ntx) * TY;
  return c;
}

// W2T [4][H] -> [HP] float4 (the four outputs of each hidden unit), zero
// padded.
__device__ __forceinline__ void load_w2(float4* w2_s, const float* __restrict__ w2t, int H, int HP) {
  for (int h = threadIdx.x; h < HP; h += NT)
    w2_s[h] = h < H ? make_float4(__ldg(w2t + h), __ldg(w2t + H + h), __ldg(w2t + 2 * H + h),
                                  __ldg(w2t + 3 * H + h))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The CD rows of a chunk: cd [nz][H][S] -> cd_s [Z][HP][S], zero past the
// chunk's rows and past H.
template <int S>
__device__ __forceinline__ void load_cd(float* cd_s, const float* __restrict__ cd, int z0, int n,
                                        int Z, int H, int HP) {
  for (int i = threadIdx.x; i < Z * HP * S; i += NT) {
    const int zl = i / (HP * S), h = (i / S) % HP, s = i % S;
    cd_s[i] = zl < n && h < H ? __ldg(cd + ((size_t)(z0 + zl) * H + h) * S + s) : 0.f;
  }
}

// The sum of v[0..N) over the warp's 32 lanes (N a power of two, at most
// 32) in a fixed shuffle tree: halving steps (the lanes with bit O set keep
// the upper half of the values, the others the lower half, and add the
// partner's), then plain xor steps. Afterwards v[0] of lane l is the sum of
// value l / (32 / N); the same bits from run to run.
template <int N, int O = 16>
__device__ __forceinline__ void warp_sum(float* v) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = threadIdx.x & O;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float send = up ? v[k] : v[k + N / 2];
        const float keep = up ? v[k + N / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_sum<N / 2, O / 2>(v);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_sum<1, O / 2>(v);
    }
  }
}

// The backward of one item: hidden units h0, h0 + 1 over the 8 x 32 cells
// of the chunk's tile and its n rows (see the file comment). gy_s holds the
// chunk's cotangents ([Z][NT] float4 for S = 1; [Z][NT][2] float4, dF and
// g / 2dt, for S = 3), cd_s its CD rows ([Z][HP][S]), w2_s W2 ([HP]
// float4). dab_part is the block's dAB partial slot [H][NT]; `first` says
// whether this chunk starts the block's rows of the tile (store) or
// continues them (add to what this lane stored). dcd_part gets the rows'
// dCD [nz][ntiles][H][S]; dw_s [HP][4] the warp's dW2T sums.
template <int S>
__device__ __forceinline__ void bwd_item(const float* __restrict__ ab, const float4* gy_s,
                                         const float* cd_s, const float4* w2_s,
                                         float* __restrict__ dab_part, float* __restrict__ dcd_part,
                                         float* dw_s, const Chunk& c, bool first, int h0, int H,
                                         int HP, int nx, int ny, int ntiles) {
  const int lane = threadIdx.x & 31, x = c.x0 + lane;
  const size_t plane = (size_t)nx * ny;
  float a[TY][HQ], dab[TY][HQ];
  float4 w[HQ];
#pragma unroll
  for (int j = 0; j < HQ; ++j) w[j] = w2_s[h0 + j];
#pragma unroll
  for (int i = 0; i < TY; ++i) {
    const bool valid = x < nx && c.y0 + i < ny;
    const size_t cell = (size_t)(c.y0 + i) * nx + x;
#pragma unroll
    for (int j = 0; j < HQ; ++j) {
      const bool on = valid && h0 + j < H;
      a[i][j] = on ? __ldg(ab + (h0 + j) * plane + cell) : 0.f;
      dab[i][j] = on && !first ? dab_part[(size_t)(h0 + j) * NT + i * TX + lane] : 0.f;
    }
  }
  float dw[HQ * 4];
#pragma unroll
  for (int k = 0; k < HQ * 4; ++k) dw[k] = 0.f;

#pragma unroll 2
  for (int zl = 0; zl < c.n; ++zl) {
    float cv[HQ][S];
#pragma unroll
    for (int j = 0; j < HQ; ++j)
#pragma unroll
      for (int s = 0; s < S; ++s) cv[j][s] = cd_s[(zl * HP + h0 + j) * S + s];
    constexpr int NC = S == 1 ? HQ : 4 * HQ;  // dCD values of the row, padded to a power of two
    float dc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) dc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < TY; ++i) {
      const int lc = i * TX + lane;
      if constexpr (S == 1) {
        const float4 g = gy_s[zl * NT + lc];
#pragma unroll
        for (int j = 0; j < HQ; ++j) {
          const float at = fmaxf(a[i][j] + cv[j][0], 0.f);
          const float p = w[j].x * g.x + w[j].y * g.y + w[j].z * g.z + w[j].w * g.w;
          const float d = at > 0.f ? p : 0.f;
          dc[j] += d;
          dab[i][j] += d;
          dw[4 * j] += at * g.x;
          dw[4 * j + 1] += at * g.y;
          dw[4 * j + 2] += at * g.z;
          dw[4 * j + 3] += at * g.w;
        }
      } else {
        const float4 f = gy_s[(zl * NT + lc) * 2], q = gy_s[(zl * NT + lc) * 2 + 1];
#pragma unroll
        for (int j = 0; j < HQ; ++j) {
          const float am = fmaxf(a[i][j] + cv[j][0], 0.f);
          const float at = fmaxf(a[i][j] + cv[j][1], 0.f);
          const float ap = fmaxf(a[i][j] + cv[j][2], 0.f);
          const float pt = w[j].x * f.x + w[j].y * f.y + w[j].z * f.z + w[j].w * f.w;
          const float pq = w[j].x * q.x + w[j].y * q.y + w[j].z * q.z + w[j].w * q.w;
          const float dm = am > 0.f ? -pq : 0.f;
          const float dt = at > 0.f ? pt : 0.f;
          const float dp = ap > 0.f ? pq : 0.f;
          dc[3 * j] += dm;
          dc[3 * j + 1] += dt;
          dc[3 * j + 2] += dp;
          dab[i][j] += dt + (dm + dp);  // dm + dp: the -+ g/(2dt) legs cancel exactly
          // dW2T: two FMAs an output (at f + dif q added first compiled to
          // an FMUL, an FFMA and an FADD).
          const float dif = ap - am;
          dw[4 * j] = fmaf(dif, q.x, fmaf(at, f.x, dw[4 * j]));
          dw[4 * j + 1] = fmaf(dif, q.y, fmaf(at, f.y, dw[4 * j + 1]));
          dw[4 * j + 2] = fmaf(dif, q.z, fmaf(at, f.z, dw[4 * j + 2]));
          dw[4 * j + 3] = fmaf(dif, q.w, fmaf(at, f.w, dw[4 * j + 3]));
        }
      }
    }
    // dCD of the row: value k = j S + s of the item, on lanes k * (32 / NC).
    warp_sum<NC>(dc);
    const int k = lane / (32 / NC), j = k / S;
    if (lane % (32 / NC) == 0 && k < HQ * S && h0 + j < H)
      dcd_part[(((size_t)(c.z0 + zl) * ntiles + c.tile) * H + h0 + j) * S + k % S] = dc[0];
  }
#pragma unroll
  for (int i = 0; i < TY; ++i) {
    if (x < nx && c.y0 + i < ny) {
#pragma unroll
      for (int j = 0; j < HQ; ++j)
        if (h0 + j < H) dab_part[(size_t)(h0 + j) * NT + i * TX + lane] = dab[i][j];
    }
  }
  // dW2T of the chunk: value 4 j + o on lanes 4 (4 j + o); the warp alone
  // owns dw_s[h0 .. h0 + 1], so it adds in chunk order.
  warp_sum<HQ * 4>(dw);
  if (lane % 4 == 0) dw_s[h0 * 4 + lane / 4] += dw[0];
}

// The block's dW2T partial [4][H] from dw_s [HP][4] (after a barrier).
__device__ __forceinline__ void store_dw2(float* __restrict__ part, const float* dw_s, int H) {
  for (int i = threadIdx.x; i < 4 * H; i += NT) part[i] = dw_s[(i % H) * 4 + i / H];
}

// Fixed-order sums of the partials with many terms each, one output element
// per thread:
//   dAB [H, ny, nx]: over the blocks that walked the cell's tile, in block
//     order (block b's partial of tile T is slot b + T of [slots][H][NT]);
//   dCD [nz, H, S]: over the ntiles tiles, in tile order.
template <int S>
__global__ void __launch_bounds__(NT)
    k_bwd_finalize(const float* __restrict__ dab_part, const float* __restrict__ dcd_part,
                   float* __restrict__ dab, float* __restrict__ dcd, int nx, int ny, int nz, int H,
                   int nblk) {
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  const size_t plane = (size_t)nx * ny, n_ab = (size_t)H * plane, n_cd = (size_t)nz * H * S;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_ab + n_cd;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < n_ab) {
      const int h = (int)(i / plane), cell = (int)(i % plane), y = cell / nx, x = cell % nx;
      const int tile = (y / TY) * ntx + x / TX, lc = (y % TY) * TX + x % TX;
      const int b1 = block_of_row((tile + 1) * nz - 1, nrows, nblk);
      for (int b = block_of_row(tile * nz, nrows, nblk); b <= b1; ++b)
        acc += dab_part[((size_t)(b + tile) * H + h) * NT + lc];
      dab[i] = acc;
    } else {
      const size_t j = i - n_ab, z = j / (S * H), hs = j % (S * H);
      const float* src = dcd_part + z * ntiles * S * H + hs;
#pragma unroll 8
      for (int t = 0; t < ntiles; ++t) acc += src[(size_t)t * S * H];
      dcd[j] = acc;
    }
  }
}

// The few outputs with a partial per block, one output element per block:
// dW2T [4, H] and db2 [4] over the nblk blocks. Each thread adds a strided
// share in order, then the block adds the shares in a fixed shuffle tree.
__global__ void __launch_bounds__(NT)
    k_bwd_reduce(const float* __restrict__ dw2_part, const float* __restrict__ db2_part,
                 float* __restrict__ dw2t, float* __restrict__ db2, int H, int nblk) {
  __shared__ float red[2 * NW];
  const int j = blockIdx.x;
  float acc = 0.f, unused = 0.f;
  if (j < 4 * H) {
    for (int b = threadIdx.x; b < nblk; b += NT) acc += dw2_part[(size_t)b * 4 * H + j];
  } else {
    for (int b = threadIdx.x; b < nblk; b += NT) acc += db2_part[(size_t)b * 4 + (j - 4 * H)];
  }
  pat::block_sum2<NT>(acc, unused, red);
  if (threadIdx.x == 0) {
    if (j < 4 * H) dw2t[j] = acc;
    else db2[j - 4 * H] = acc;
  }
}

// Launch both sums on stream s: dAB and dCD, then dW2T and db2.
template <int S>
cudaError_t launch_sums(const float* dab_part, const float* dcd_part, const float* dw2_part,
                        const float* db2_part, float* dab, float* dcd, float* dw2t, float* db2,
                        int nx, int ny, int nz, int H, int nblk, cudaStream_t s) {
  const size_t total = (size_t)H * nx * ny + (size_t)nz * H * S;
  const int fin_blocks = (int)((total + NT - 1) / NT < 4096 ? (total + NT - 1) / NT : 4096);
  k_bwd_finalize<S><<<fin_blocks, NT, 0, s>>>(dab_part, dcd_part, dab, dcd, nx, ny, nz, H, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_bwd_reduce<<<4 * H + 4, NT, 0, s>>>(dw2_part, db2_part, dw2t, db2, H, nblk);
  return cudaGetLastError();
}

}  // namespace mlph
}  // namespace
