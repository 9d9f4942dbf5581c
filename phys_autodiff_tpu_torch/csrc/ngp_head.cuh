// The tiled head core of the encoded field, shared by K5 (mega_ngp.cu) and
// K7 (fit_ngp.cu).
//
// The head is base = W1c^T enc, a1 = relu(base + tb1), y = W2^T a1 + b2 per
// cell. A block owns one 32 x 8 (x, y) tile row at a time (NT = 256 cells)
// and, for that row, computes three small matrix products out of shared
// memory, each with register micro-tiles, so that one 16-byte shared load
// feeds 8 to 16 FMAs (a thread-per-cell loop feeds one or two):
//   (i)   base [cells x LF] . [LF x H]: a head item is TM = 4 cells x 4
//         hidden units; per 4 channels a thread loads 4 float4 of W1c and
//         TM float4 of the encoding for 64 FMAs. The kernels run their
//         elementwise head work (B1: ReLU masks, W2 . gy, dz1, the db1 /
//         dtw1 / dW2 register sums) on the item while it is in registers.
//   (ii)  dEnc [cells x H] . [H x LF]: 4 cells x 4 channels a thread, per 4
//         hidden units 4 float4 of dz1 and 4 of W1c for 64 FMAs; the
//         channel quads run fastest over the threads, so a warp's loads
//         hit few cells and rows, and its stores are 32-byte runs.
//   (iii) dW1c += [LF x cells] . [cells x H]: 4 channels x 4 hidden units a
//         thread, the row's cells split S ways when the [LF x H] output has
//         fewer than NT such tiles; per cell one float4 of the encoding and
//         one of dz1 for 16 FMAs, summed in registers over every row the
//         block walks; the splits are added in a fixed order at the end.
// Sums over LF in (i) and over H in (ii) run in index order with one FMA
// each, as the thread-per-cell loops they replace did; nothing is added
// with atomics, so every output has the same bits from run to run.
//
// Padding: LF and H are padded to multiples of 4 (LFP, HP) with zero
// weights and zero encoding channels, which add exact zeros; the row
// strides of the encoding (LFS) and dz1 (HS) are 4 mod 8 floats, so the 8
// threads of a quarter warp that load float4 of 8 neighbouring cells hit
// 32 different banks.
//
// Tiers (the kernels' TIER template argument; kernels/_build.NGP_TIER_CODES):
// TIER_F32, the FFMA maps above, bound by the FP32 operations; TIER_BF16,
// where every operand of the three products and of the Out = 4 products
// (layer 2, da1, dW2) is rounded to bf16 (to nearest even) and the sums
// stay float32 (JAX's Precision.DEFAULT on the TPU: pallas/fit.py:440-527,
// pallas/mega_ngp.py:280-446); TIER_FASTBWD (K5 only), the f32 forward with
// a backward that rounds the recomputed base and, in (iii), the encoding.
// K5 runs its reduced tiers on kernels of its own (mega_ngp.cu: bf16 with
// every product on the tensor cores and the head's C fragments kept in
// registers; fastbwd's (iii) on them as exact bf16 splits), so the mma
// routines below serve K7's bf16 tier (fit_ngp.cu), mma.sync m16n8k16 with
// bf16 operands and float32 accumulation (mlp_mma.cuh's pack2 and fragment
// maps: A 16 x 16 {a0..a3} = rows g, g + 8 x columns 2t + {0, 1}, + 8; B
// 16 x 8 {b0, b1} = rows 2t + {0, 1}, + 8 x column g; C {c0..c3} = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)), each operand rounded as pack2
// packs it from shared memory:
//   (i)   base_rows_mma: cells on M (a warp's two m16 tiles of the row),
//         hidden units on N, channels on K (one k-step at LF = 16); base
//         to shared memory, where the elementwise work reads it.
//   (ii)  denc_rows_mma: cells on M, channels on N, hidden units on K.
//   (iii) dw1_rows_mma: channels on M, hidden units on N, the row's 256
//         cells on K; a warp owns TPW of the [LF x H] output's m16 x n8
//         tiles and keeps them in registers over every row it walks.
// Padding to 16 (K) and 8 (N) reads zeros, never past a row. K7's Out = 4
// products stay on the CUDA cores with operands rounded once (W2 as it is
// loaded, gy as it is stored, a1 where it is formed); there the FFMA work
// around the products bounds the tier. mma.sync's sums are deterministic,
// so the tier keeps the same bits from run to run.
//
// Grid: persistent. The ntx * nty * nz tile rows are dealt in contiguous
// ranges (tile-major, z fastest) to min(rows, NBLK) blocks, NBLK = 264: two
// blocks on each of the H100's 132 SMs, one whole wave when two blocks fit
// an SM (the kernels keep the shared memory of the flagship LF = 16, H = 64
// near 100 KB for that). Blocks take 17 or 18 of the 4,608 rows of
// 128x96x96. The block count is a constant, not the card's SM count, so
// the partial sums have one order on any card.

#pragma once

#include <cuda_bf16.h>

#include "mlp_mma.cuh"
#include "stencil.cuh"

namespace {  // internal linkage: each kernel source has its own copy
namespace ngp {

constexpr int NT = pat::TILE_THREADS;  // cells of a tile row, threads of a block
constexpr int TX = pat::TILE_X;
constexpr int TY = pat::TILE_Y;
constexpr int TM = 4;                  // cells of a head item
constexpr int NCG = NT / TM;           // cell groups of a row; cell = cg + i * NCG
constexpr int NBLK = 264;              // most blocks of the persistent grid
constexpr int RED_FLOATS = 6144;       // end-of-block scratch: >= 6 * 4 * NT and 16 * NT
constexpr int SMEM_LIMIT = 232448;     // shared memory a block may use (dynamic + static)
constexpr int SMEM_STATIC = 64;        // the kernels' static block-sum scratch
constexpr int TIER_F32 = 0, TIER_BF16 = 1, TIER_FASTBWD = 2;

// x rounded to bf16 (to nearest even), as float.
__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float4 bfr4(float4 v) { return make_float4(bfr(v.x), bfr(v.y), bfr(v.z), bfr(v.w)); }

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
// A row stride of n4 floats (a multiple of 4) that is 4 mod 8.
__host__ __device__ inline int row_stride(int n4) { return n4 % 8 == 0 ? n4 + 4 : n4; }

// The head's extents and the thread maps of the three products.
struct Shape {
  int LF, LFP, LFS;  // channels, padded, encoding row stride
  int H, HP, HS;     // hidden units, padded, dz1 row stride
  int nhg, tpg;      // (i): hidden-unit quads; threads per quad (thread = sub * nhg + hg)
  int ntile, S;      // (iii): 4x4 tiles of dW1c; cell splits of a row
};

__host__ __device__ inline Shape make_shape(int LF, int H) {
  Shape s;
  s.LF = LF;
  s.LFP = pad4(LF);
  s.LFS = row_stride(s.LFP);
  s.H = H;
  s.HP = pad4(H);
  s.HS = row_stride(s.HP);
  s.nhg = s.HP / 4;
  s.tpg = NT / s.nhg;
  s.ntile = (s.LFP / 4) * s.nhg;
  s.S = s.ntile >= NT ? 1 : NT / s.ntile;
  return s;
}

// Tiles of (iii) a thread owns (the kernels' template argument): 1, or 2
// where LF x H passes 4,096 (LF = 64 with H above 64, the widest the
// shared memory takes being H = 116); 0 beyond that.
__host__ inline int tiles_per_thread(const Shape& s) {
  const int t = (s.ntile + NT - 1) / NT;
  return t <= 2 ? t : 0;
}

// Dynamic shared memory, in floats: W1c [LFP][HS], W2 [HP] float4, tb1
// [HP] float4 (the slices' biases), gy [NT][ngy] float4, the row's
// encoding [NT][LFS] and dz1 (or base) [NT][HS]. After the last row the
// end-of-block scratch (RED_FLOATS) overlays the encoding onward.
struct Smem {
  int w1, w2, tb, gy, enc, dz, total;
};

__host__ __device__ inline Smem layout(const Shape& s, int ngy) {
  Smem m;
  m.w1 = 0;
  m.w2 = m.w1 + s.LFP * s.HS;
  m.tb = m.w2 + 4 * s.HP;
  m.gy = m.tb + 4 * s.HP;
  m.enc = m.gy + 4 * ngy * NT;
  m.dz = m.enc + NT * s.LFS;
  const int rows = m.dz + NT * s.HS, red = m.enc + RED_FLOATS;
  m.total = rows > red ? rows : red;
  return m;
}

// The contiguous range [r0, r1) of tile rows of this block.
__device__ __forceinline__ void block_rows(int nrows, int& r0, int& r1) {
  r0 = (int)((long long)blockIdx.x * nrows / gridDim.x);
  r1 = (int)((long long)(blockIdx.x + 1) * nrows / gridDim.x);
}

// W1c [LF][H] -> [LFP][HS] and W2 [H][4] -> [HP] float4, zero padded;
// rounded to bf16 when `round` (TIER_BF16).
__device__ __forceinline__ void load_weights(float* sh, const Shape& s, const Smem& m,
                                             const float* __restrict__ w1c,
                                             const float* __restrict__ w2, bool round = false) {
  for (int i = threadIdx.x; i < s.LFP * s.HS; i += NT) {
    const int c = i / s.HS, h = i % s.HS;
    const float v = c < s.LF && h < s.H ? __ldg(w1c + c * s.H + h) : 0.f;
    sh[m.w1 + i] = round ? bfr(v) : v;
  }
  for (int i = threadIdx.x; i < 4 * s.HP; i += NT) {
    const float v = i < 4 * s.H ? __ldg(w2 + i) : 0.f;
    sh[m.w2 + i] = round ? bfr(v) : v;
  }
}

// tb1 [H][nslice] -> [HP] float4 (x, y, z: the slices), zero padded.
__device__ __forceinline__ void load_biases(float* sh, const Shape& s, const Smem& m,
                                            const float* __restrict__ tb1, int nslice) {
  for (int i = threadIdx.x; i < 4 * s.HP; i += NT) {
    const int h = i / 4, k = i % 4;
    sh[m.tb + i] = h < s.H && k < nslice ? __ldg(tb1 + h * nslice + k) : 0.f;
  }
}

// The row's encoding, thread per cell: the LF channels of enc [nz][LF]
// [plane] at the cell -> enc_s[tid][0..LF), copied asynchronously
// (cp.async) so that the copy overlaps the work a kernel does between
// issuing it and wait_enc_row. Padded channels keep the zeros of
// zero_enc_rows; the slot of a cell off the grid keeps what it held (zero,
// or an earlier cell's finite encoding), which only ever meets zero
// cotangents and is never stored.
__device__ __forceinline__ void copy_enc_row(float* enc_s, const Shape& s,
                                             const float* __restrict__ enc, int z, size_t plane,
                                             size_t cell, bool valid) {
  if (valid) {
    float* row = enc_s + threadIdx.x * s.LFS;
    const float* src = enc + (size_t)z * s.LF * plane + cell;
    for (int c = 0; c < s.LF; ++c) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(row + c);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src + c * plane) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies of copy_enc_row (the block still has to
// synchronise before other threads read them).
__device__ __forceinline__ void wait_enc_row() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Zero the encoding rows once, before the first copy_enc_row.
__device__ __forceinline__ void zero_enc_rows(float* enc_s, const Shape& s) {
  for (int i = threadIdx.x; i < NT * s.LFS; i += NT) enc_s[i] = 0.f;
}

// Product (i) for one head item: b[i][j] = base of cell cg + i * NCG at
// hidden unit 4 hg + j, the channels added in order.
__device__ __forceinline__ void base_item(float (&b)[TM][4], const float* w1_s,
                                          const float* enc_s, const Shape& s, int cg, int hg) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) b[i][j] = 0.f;
  const float* wp = w1_s + 4 * hg;
  for (int c = 0; c < s.LFP; c += 4) {
    const float4 w0 = *reinterpret_cast<const float4*>(wp + c * s.HS);
    const float4 w1 = *reinterpret_cast<const float4*>(wp + (c + 1) * s.HS);
    const float4 w2 = *reinterpret_cast<const float4*>(wp + (c + 2) * s.HS);
    const float4 w3 = *reinterpret_cast<const float4*>(wp + (c + 3) * s.HS);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 e = *reinterpret_cast<const float4*>(enc_s + (cg + i * NCG) * s.LFS + c);
      b[i][0] = fmaf(w3.x, e.w, fmaf(w2.x, e.z, fmaf(w1.x, e.y, fmaf(w0.x, e.x, b[i][0]))));
      b[i][1] = fmaf(w3.y, e.w, fmaf(w2.y, e.z, fmaf(w1.y, e.y, fmaf(w0.y, e.x, b[i][1]))));
      b[i][2] = fmaf(w3.z, e.w, fmaf(w2.z, e.z, fmaf(w1.z, e.y, fmaf(w0.z, e.x, b[i][2]))));
      b[i][3] = fmaf(w3.w, e.w, fmaf(w2.w, e.z, fmaf(w1.w, e.y, fmaf(w0.w, e.x, b[i][3]))));
    }
  }
}

// Product (ii) for the row: dEnc[c, cell] = sum_h W1c[c, h] dz1[cell, h],
// hidden units in order, stored to out [LF][plane] (the row's z plane) at
// the cells of the tile with origin (x0, y0) that lie on the grid. An item
// is cells q + 64 i x channels cq + ncq k (i, k < 4, ncq = LFP / 4), cq
// fastest over the threads: at LF = 16 a warp reads 8 cells' dz1 and 4
// rows of W1c, one wavefront each, and stores 4 channels x 8 neighbouring
// cells.
__device__ __forceinline__ void denc_row(float* __restrict__ out, size_t plane, int x0, int y0,
                                         int nx, int ny, const float* w1_s, const float* dz_s,
                                         const Shape& s) {
  const int ncq = s.LFP / 4;
  for (int it = threadIdx.x; it < 64 * ncq; it += NT) {
    const int cq = it % ncq, q = it / ncq;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    const float* wp = w1_s + cq * s.HS;
    for (int h = 0; h < s.HP; h += 4) {
      float4 w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = *reinterpret_cast<const float4*>(wp + k * ncq * s.HS + h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 d = *reinterpret_cast<const float4*>(dz_s + (q + 64 * i) * s.HS + h);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][k] = fmaf(w[k].w, d.w, fmaf(w[k].z, d.z, fmaf(w[k].y, d.y, fmaf(w[k].x, d.x, acc[i][k]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cl = q + 64 * i, cx = x0 + cl % TX, cy = y0 + cl / TX;
      if (cx < nx && cy < ny) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (cq + ncq * k < s.LF) out[(size_t)(cq + ncq * k) * plane + (size_t)cy * nx + cx] = acc[i][k];
      }
    }
  }
}

// Product (iii) for the row: acc[t] += enc^T dz1 over the row's cells of
// the thread's split, for each dW1c tile t the thread owns (tile = tid %
// ntile, split = tid / ntile when S > 1; tiles tid + k NT when S == 1).
// acc[t][4 r + j] is dW1c[4 cq + r, 4 hq + j] of tile (cq, hq).
template <int TPT>
__device__ __forceinline__ void dw1_row(float (&acc)[TPT][16], const float* enc_s,
                                        const float* dz_s, const Shape& s) {
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    int tile = threadIdx.x + k * NT, split = 0;
    if (s.S > 1) {
      tile = threadIdx.x % s.ntile;
      split = threadIdx.x / s.ntile;
      if (k > 0 || split >= s.S) break;
    } else if (tile >= s.ntile) {
      break;
    }
    const float* ep = enc_s + (tile / s.nhg) * 4;
    const float* dp = dz_s + (tile % s.nhg) * 4;
#pragma unroll 4  // four cells' loads in flight at once
    for (int cl = split; cl < NT; cl += s.S) {
      const float4 e = *reinterpret_cast<const float4*>(ep + cl * s.LFS);
      const float4 d = *reinterpret_cast<const float4*>(dp + cl * s.HS);
      const float ev[4] = {e.x, e.y, e.z, e.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][4 * r + j] = fmaf(ev[r], dv[j], acc[k][4 * r + j]);
    }
  }
}

// The block's dW1c partial [LF][H] from the (iii) accumulators: the splits
// added in order through `red` (RED_FLOATS of shared scratch that no
// thread reads any more). Ends with the block synchronised.
template <int TPT>
__device__ __forceinline__ void dw1_store(float* __restrict__ part, const float (&acc)[TPT][16],
                                          float* red, const Shape& s) {
  if (s.S == 1) {
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tile = threadIdx.x + k * NT;
      if (tile >= s.ntile) break;
      const int c0 = (tile / s.nhg) * 4, h0 = (tile % s.nhg) * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + r < s.LF && h0 + j < s.H) part[(c0 + r) * s.H + h0 + j] = acc[k][4 * r + j];
    }
    __syncthreads();
    return;
  }
  if (threadIdx.x < s.S * s.ntile) {
#pragma unroll
    for (int v = 0; v < 16; ++v) red[threadIdx.x * 16 + v] = acc[0][v];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < s.LF * s.H; o += NT) {
    const int c = o / s.H, h = o % s.H;
    const int tile = (c / 4) * s.nhg + h / 4, v = (c % 4) * 4 + h % 4;
    float sum = 0.f;
    for (int sp = 0; sp < s.S; ++sp) sum += red[(sp * s.ntile + tile) * 16 + v];
    part[o] = sum;
  }
  __syncthreads();
}

// The block's head partial [H][NV] from each thread's register sums
// vals[j][v] of hidden unit 4 hg + j (the threads of one quad added in
// order of sub through `red`). Ends with the block synchronised.
template <int NV>
__device__ __forceinline__ void head_store(float* __restrict__ part, const float (&vals)[4][NV],
                                           float* red, const Shape& s) {
  const int hg = threadIdx.x % s.nhg, sub = threadIdx.x / s.nhg;
  const int nsub = s.tpg < NCG ? s.tpg : NCG;  // threads of a quad that own head items
  if (sub < nsub) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < NV; ++v) red[(sub * s.HP + 4 * hg + j) * NV + v] = vals[j][v];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < s.H * NV; o += NT) {
    float sum = 0.f;
    for (int sp = 0; sp < nsub; ++sp) sum += red[sp * s.HP * NV + o];
    part[o] = sum;
  }
  __syncthreads();
}

// ---- TIER_BF16 on the tensor cores -------------------------------------

using mma16::mma16816;
using mma16::pack2;

// m16 x n8 tiles of dW1c (M = channels, N = hidden units) a warp owns in
// dw1_rows_mma: 1, 2, 4 or 8 (the kernels' template argument), 0 past 8.
__host__ inline int mma_tiles_per_warp(const Shape& s) {
  const int tiles = ((s.LFP + 15) / 16) * ((s.HP + 7) / 8);
  const int per = (tiles + NT / 32 - 1) / (NT / 32);
  return per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : 0;
}

// Two neighbouring floats of a shared row as one packed bf16 pair, zero
// at and past `end` (a multiple of 2, so a pair is all in or all out).
__device__ __forceinline__ uint32_t pair_at(const float* row, int k, int end) {
  if (k >= end) return 0u;
  const float2 v = *reinterpret_cast<const float2*>(row + k);
  return pack2(v.x, v.y);
}

// Two floats one column apart in two shared rows (k, k + 1) as a packed
// pair, zero past `end` in the column index or `kend` in the row index.
__device__ __forceinline__ uint32_t col_pair(const float* m, int stride, int k, int kend, int n, int end) {
  const float lo = k < kend && n < end ? m[k * stride + n] : 0.f;
  const float hi = k + 1 < kend && n < end ? m[(k + 1) * stride + n] : 0.f;
  return pack2(lo, hi);
}

// Product (i) on the tensor cores: base [cell][h] of the row's NT cells to
// out (the dz1 area, row stride HS), base = bf16(enc) bf16(W1c).
__device__ __forceinline__ void base_rows_mma(float* out, const float* enc_s, const float* w1_s, const Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nkb = (s.LFP + 15) / 16, nnb = (s.HP + 7) / 8;
  for (int mt = warp; mt < NT / 16; mt += NT / 32) {
    const float* r0 = enc_s + (16 * mt + g) * s.LFS;
    const float* r8 = r0 + 8 * s.LFS;
    uint32_t a[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < nkb) {
        const int k = 16 * kb + 2 * t;
        a[kb][0] = pair_at(r0, k, s.LFP);
        a[kb][1] = pair_at(r8, k, s.LFP);
        a[kb][2] = pair_at(r0, k + 8, s.LFP);
        a[kb][3] = pair_at(r8, k + 8, s.LFP);
      }
    }
    for (int nb = 0; nb < nnb; ++nb) {
      const int n = 8 * nb + g;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb < nkb) {
          const int k = 16 * kb + 2 * t;
          mma16816(d, a[kb][0], a[kb][1], a[kb][2], a[kb][3], col_pair(w1_s, s.HS, k, s.LFP, n, s.HP),
                   col_pair(w1_s, s.HS, k + 8, s.LFP, n, s.HP));
        }
      }
      const int h = 8 * nb + 2 * t;
      if (h < s.HP) {
        *reinterpret_cast<float2*>(out + (16 * mt + g) * s.HS + h) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(out + (16 * mt + g + 8) * s.HS + h) = make_float2(d[2], d[3]);
      }
    }
  }
}

// Product (ii) on the tensor cores: dEnc = bf16(dz1) bf16(W1c)^T of the row,
// stored to out [LF][plane] (the row's z plane) at the cells of the tile
// with origin (x0, y0) that lie on the grid.
__device__ __forceinline__ void denc_rows_mma(float* __restrict__ out, size_t plane, int x0, int y0, int nx,
                                              int ny, const float* w1_s, const float* dz_s, const Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nkb = (s.HP + 15) / 16, nnb = (s.LFP + 7) / 8;
  for (int mt = warp; mt < NT / 16; mt += NT / 32) {
    const float* r0 = dz_s + (16 * mt + g) * s.HS;
    const float* r8 = r0 + 8 * s.HS;
    for (int nb = 0; nb < nnb; ++nb) {
      const float* wrow = w1_s + (8 * nb + g) * s.HS;  // W1c row of channel 8 nb + g
      const bool wvalid = 8 * nb + g < s.LFP;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kb = 0; kb < nkb; ++kb) {
        const int k = 16 * kb + 2 * t;
        mma16816(d, pair_at(r0, k, s.HP), pair_at(r8, k, s.HP), pair_at(r0, k + 8, s.HP), pair_at(r8, k + 8, s.HP),
                 wvalid ? pair_at(wrow, k, s.HP) : 0u, wvalid ? pair_at(wrow, k + 8, s.HP) : 0u);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = 16 * mt + g + 8 * half, cx = x0 + cl % TX, cy = y0 + cl / TX;
        if (cx < nx && cy < ny) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 8 * nb + 2 * t + j;
            if (c < s.LF) out[(size_t)c * plane + (size_t)cy * nx + cx] = d[2 * half + j];
          }
        }
      }
    }
  }
}

// Product (iii) on the tensor cores: acc[i] += bf16(enc)^T bf16(dz1) over
// the row's NT cells for the warp's tiles warp + i NW (tile = mt * nnb +
// nb: channels 16 mt.., hidden units 8 nb..), i < TPW.
template <int TPW>
__device__ __forceinline__ void dw1_rows_mma(float (&acc)[TPW][4], const float* enc_s, const float* dz_s,
                                             const Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nnb = (s.HP + 7) / 8, ntiles = ((s.LFP + 15) / 16) * nnb;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + i * (NT / 32);
    if (tile >= ntiles) break;
    const int c0 = 16 * (tile / nnb), n = 8 * (tile % nnb) + g;
#pragma unroll 2
    for (int k = 2 * t; k < NT; k += 16) {  // cells k, k + 1 and k + 8, k + 9 of each k-step
      const uint32_t a0 = col_pair(enc_s, s.LFS, k, NT, c0 + g, s.LFP);
      const uint32_t a1 = col_pair(enc_s, s.LFS, k, NT, c0 + g + 8, s.LFP);
      const uint32_t a2 = col_pair(enc_s, s.LFS, k + 8, NT, c0 + g, s.LFP);
      const uint32_t a3 = col_pair(enc_s, s.LFS, k + 8, NT, c0 + g + 8, s.LFP);
      mma16816(acc[i], a0, a1, a2, a3, col_pair(dz_s, s.HS, k, NT, n, s.HP), col_pair(dz_s, s.HS, k + 8, NT, n, s.HP));
    }
  }
}

// The block's dW1c partial [LF][H] from dw1_rows_mma's accumulators.
template <int TPW>
__device__ __forceinline__ void dw1_store_mma(float* __restrict__ part, const float (&acc)[TPW][4], const Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nnb = (s.HP + 7) / 8, ntiles = ((s.LFP + 15) / 16) * nnb;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + i * (NT / 32);
    if (tile >= ntiles) break;
    const int c0 = 16 * (tile / nnb) + g, h0 = 8 * (tile % nnb) + 2 * t;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 8 * (v >> 1), h = h0 + (v & 1);
      if (c < s.LF && h < s.H) part[c * s.H + h] = acc[i][v];
    }
  }
}

// out[j] = sum over p of part[p, j], one output element per block: each
// thread adds a strided share in order, then the block adds the shares in
// a fixed shuffle tree (deterministic).
__global__ void __launch_bounds__(NT)
    k_sum_parts(const float* __restrict__ part, float* __restrict__ out, int nout, int nparts) {
  __shared__ float red[2 * (NT / 32)];
  const int j = blockIdx.x;
  float acc = 0.f, unused = 0.f;
  for (int p = threadIdx.x; p < nparts; p += NT) acc += part[(size_t)p * nout + j];
  pat::block_sum2<NT>(acc, unused, red);
  if (threadIdx.x == 0) out[j] = acc;
}

}  // namespace ngp
}  // namespace
