// The encoded field's head in bf16 on the tensor cores, shared by K5 bf16
// (mega_ngp.cu) and K7 bf16 (fit_ngp.cu): every product on mma.sync
// (m16n8k16 / m16n8k8, bf16 operands, float32 sums; mlp_mma.cuh's fragment
// maps and pack2), operands read by ldmatrix (.trans) from bf16 [channel or
// hidden unit][cell] tiles of a 32 x 8 tile row, the elementwise work on
// the C fragments in registers.
//   forward, cells on M (fwd_base): base = bf16(enc) bf16(W1c) per 16
//     hidden units, + tb1_s, ReLU and bf16 into the A fragment of y_s +=
//     bf16(a1_s) bf16(W2); base never leaves registers.
//   backward, hidden units on M, per 16 cells of a row: base^T = W1c^T enc^T
//     recomputed (base_t), da1^T = [W2 | 0] . [gy_a | gy_b] (m16n8k8 over
//     the cotangents stored as one 16-byte bf16 row a cell), B1 on the C
//     fragments, dW1^T += bf16(dz1) . enc (dw1_step), and dz1 stored
//     hidden-major in bf16 (store_dz) for dEnc = bf16(dz1) bf16(W1c)^T,
//     cells on M (denc_row), which reads it with ldmatrix.trans.
// The C fragments of two 8-cell tiles are the A fragment of a 16-cell
// k-step, so none of base, a1 or dz1 leaves registers but the dz1 that
// dEnc reads. The kernels pack their operands once a block (W1c's and W2's
// fragments in fragment order: one 8- or 16-byte shared load a lane) and
// read each tile row's encoding once, rounding it to bf16 as it arrives.

#pragma once

#include "ngp_head.cuh"

namespace {  // internal linkage: each kernel source has its own copy
namespace ngp {

// The tile row r of the persistent walk: tile (tx, ty) = r / nz, z = r % nz.
struct Row {
  int x0, y0, z, gx, gy;
  bool valid;
};

__device__ __forceinline__ Row tile_row(int r, int ntx, int nx, int ny, int nz) {
  Row w;
  const int tile = r / nz;
  w.z = r % nz;
  w.x0 = (tile % ntx) * TX;
  w.y0 = (tile / ntx) * TY;
  w.gx = w.x0 + threadIdx.x % TX;
  w.gy = w.y0 + threadIdx.x / TX;
  w.valid = w.gx < nx && w.gy < ny;
  return w;
}

}  // namespace ngp

namespace bfk {

using mma16::mma16816;
using mma16::mma1688;
using mma16::pack2;
using mma16::relu2;
using mma16::ldsm2;
using mma16::ldsm2_t;
using mma16::ldsm4;
using mma16::ldsm4_t;
using ngp::NT;
using ngp::TX;

// bf16 row stride of the [channel or hidden unit][cell] tiles: 264 halves,
// 132 words, 4 mod 32, so the 8 rows of an ldmatrix phase hit 32 banks.
constexpr int ES = NT + 8;
// The most dynamic shared memory a block may take with two blocks an SM
// (228 KB an SM, 1 KB of it reserved a block), less the static scratch.
constexpr int SMEM_2BLK = 115712 - ngp::SMEM_STATIC;

// The head's extents in 16s: nkc channel k-steps (LFP = 16 nkc), nmt
// hidden-unit tiles (HP = 16 nmt, padded with zero weights: exact zeros);
// S: the backward's cell splits, the warps that share an m-tile when
// nmt <= 8.
struct Dims {
  int LF, H, nkc, nmt, S;
  __host__ __device__ int LFP() const { return 16 * nkc; }
  __host__ __device__ int HP() const { return 16 * nmt; }
};

__host__ __device__ inline Dims make_dims(int LF, int H) {
  Dims d;
  d.LF = LF;
  d.H = H;
  d.nkc = (LF + 15) / 16;
  d.nmt = (H + 15) / 16;
  d.S = d.nmt > 4 ? 1 : d.nmt > 2 ? 2 : d.nmt == 2 ? 4 : 8;
  return d;
}

// The NKC template argument of the kernels: channel k-steps, rounded up to
// 1, 2 or 4 (a k-step past nkc is skipped).
__host__ inline int nkc_class(const Dims& d) { return d.nkc <= 1 ? 1 : d.nkc <= 2 ? 2 : 4; }

// The warp's m-tiles and cells in the backward: with nmt <= 8, m-tile
// warp % nmt, cell split warp / nmt of S (warps past nmt S idle in the
// products); past 8 (MPW = 2), m-tiles warp and warp + 8, every cell.
// q0 .. q1: the 16-cell k-steps of the row it takes.
template <int MPW>
struct Owned {
  int mts[MPW];
  bool own[MPW];
  int split, q0, q1;
};

template <int MPW>
__device__ __forceinline__ Owned<MPW> owned(const Dims& d, int warp) {
  Owned<MPW> o;
  o.split = MPW == 1 ? warp / d.nmt : 0;
  const int nq = 16 / d.S;
  o.q0 = o.split * nq;
  o.q1 = o.q0 + nq;
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    o.mts[i] = MPW == 1 ? warp % d.nmt : warp + 8 * i;
    o.own[i] = MPW == 1 ? warp < d.nmt * d.S : o.mts[i] < d.nmt;
  }
  return o;
}

// W1c [LF][H] as W1c^T's A fragments w1a [nmt][nkc][32] uint4 (m hidden
// units, k channels: base^T). The same registers are the forward's B
// fragments (k channels, n hidden units): of hidden units 16 mt + g,
// {x, z}; of 16 mt + 8 + g, {y, w} (fwd_base).
__device__ __forceinline__ void load_w1a(uint4* w1a, const float* __restrict__ w1c, const Dims& d) {
  const int LF = d.LF, H = d.H;
  auto W1 = [&](int c, int h) { return c < LF && h < H ? __ldg(w1c + c * H + h) : 0.f; };
  for (int i = threadIdx.x; i < d.nmt * d.nkc * 32; i += NT) {
    const int ln = i & 31, f = i >> 5, h = 16 * (f / d.nkc) + (ln >> 2), c = 16 * (f % d.nkc) + 2 * (ln & 3);
    w1a[i] = make_uint4(pack2(W1(c, h), W1(c + 1, h)), pack2(W1(c, h + 8), W1(c + 1, h + 8)),
                        pack2(W1(c + 8, h), W1(c + 9, h)), pack2(W1(c + 8, h + 8), W1(c + 9, h + 8)));
  }
}

// W1c^T's B fragments w1b [nmt][2 nkc][32] uint2 (k hidden units, n
// channels; dEnc).
__device__ __forceinline__ void load_w1b(uint2* w1b, const float* __restrict__ w1c, const Dims& d) {
  const int nc8 = 2 * d.nkc, LF = d.LF, H = d.H;
  auto W1 = [&](int c, int h) { return c < LF && h < H ? __ldg(w1c + c * H + h) : 0.f; };
  for (int i = threadIdx.x; i < d.nmt * nc8 * 32; i += NT) {
    const int ln = i & 31, f = i >> 5, h = 16 * (f / nc8) + 2 * (ln & 3), c = 8 * (f % nc8) + (ln >> 2);
    w1b[i] = make_uint2(pack2(W1(c, h), W1(c, h + 1)), pack2(W1(c, h + 8), W1(c, h + 9)));
  }
}

// W2 [H][4] as layer 2's B fragments: w2f[kh * 32 + lane], hidden units
// 16 kh + 2t (+1, +8, +9), output g; zero past H and output 3.
__device__ __forceinline__ void load_w2f(uint2* w2f, const float* __restrict__ w2, const Dims& d) {
  const int H = d.H;
  auto W2 = [&](int h, int o) { return h < H && o < 4 ? __ldg(w2 + 4 * h + o) : 0.f; };
  for (int i = threadIdx.x; i < d.nmt * 32; i += NT) {
    const int ln = i & 31, h = 16 * (i >> 5) + 2 * (ln & 3), o = ln >> 2;
    w2f[i] = make_uint2(pack2(W2(h, o), W2(h + 1, o)), pack2(W2(h + 8, o), W2(h + 9, o)));
  }
}

// A tile row's encoding to eb [LFP][ES] as bf16, thread per cell: the
// cell's LF channels of enc [.., LF, plane] at row z, read in float32 (a
// warp's 32 cells of a channel are contiguous) and rounded once; zero past
// LF and off the grid. enc_head reads the first 16 channels into registers
// (issued ahead of the work that hides their latency); enc_store stores
// them and reads and stores the rest.
__device__ __forceinline__ void enc_head(float (&v)[16], const Dims& d, const float* __restrict__ enc, int z,
                                         size_t plane, size_t cell, bool valid) {
  const float* src = enc + (size_t)z * d.LF * plane + cell;
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = valid && i < d.LF ? __ldg(src + (size_t)i * plane) : 0.f;
}

__device__ __forceinline__ void enc_store(uint16_t* eb, const float (&v)[16], const Dims& d,
                                          const float* __restrict__ enc, int z, size_t plane, size_t cell,
                                          bool valid) {
#pragma unroll
  for (int i = 0; i < 16; ++i) eb[i * ES + threadIdx.x] = mma16::bf16_bits(v[i]);
  const float* src = enc + (size_t)z * d.LF * plane + cell;
  for (int c0 = 16; c0 < d.LFP(); c0 += 8) {
    float u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = valid && c0 + i < d.LF ? __ldg(src + (size_t)(c0 + i) * plane) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) eb[(c0 + i) * ES + threadIdx.x] = mma16::bf16_bits(u[i]);
  }
}

// The forward's A fragments of the warp's cells 16 (warp + 8 mi) .. + 15
// (rows) x channels (columns) from the [channel][cell] tile eb: .trans of
// (channels 8 (jm >> 1).., cells 8 (jm & 1)..).
template <int NKC>
__device__ __forceinline__ void fwd_enc_frags(uint32_t (&ea)[2][NKC][4], const uint16_t* eb, const Dims& d,
                                              int warp, int jm, int jr) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc)
      if (kc < d.nkc) ldsm4_t(ea[mi][kc], eb + (16 * kc + 8 * (jm >> 1) + jr) * ES + 16 * (warp + 8 * mi) + 8 * (jm & 1));
}

// base of the 16 cells of ea[mi] for the hidden units 16 kh + g.. (as
// columns): c0 the n8 tile 16 kh.., c1 16 kh + 8.. (C fragments: cells g,
// g + 8 x hidden units 2t, 2t + 1 of the tile); B from W1c^T's A fragments
// (load_w1a).
template <int NKC>
__device__ __forceinline__ void fwd_base(float (&c0)[4], float (&c1)[4], const uint32_t (&ea)[NKC][4],
                                         const uint4* w1a, const Dims& d, int kh, int lane) {
#pragma unroll
  for (int v = 0; v < 4; ++v) c0[v] = c1[v] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    if (kc < d.nkc) {
      const uint4 f = w1a[(kh * d.nkc + kc) * 32 + lane];
      mma16816(c0, ea[kc][0], ea[kc][1], ea[kc][2], ea[kc][3], f.x, f.z);
      mma16816(c1, ea[kc][0], ea[kc][1], ea[kc][2], ea[kc][3], f.y, f.w);
    }
  }
}

// base^T of hidden units 16 mt + g (+ 8) x the 16 cells cq.. (two n8
// tiles): A W1c^T's fragments, B from the [channel][cell] tile eb, .trans
// of (channels 8 (jm & 1).., cells 8 (jm >> 1)..).
template <int NKC>
__device__ __forceinline__ void base_t(float (&cb)[2][4], const uint4* w1a, const uint16_t* eb, const Dims& d,
                                       int mt, int cq, int lane, int jm, int jr) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) cb[n][v] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    if (kc < d.nkc) {
      const uint4 a = w1a[(mt * d.nkc + kc) * 32 + lane];
      uint32_t e[4];
      ldsm4_t(e, eb + (16 * kc + 8 * (jm & 1) + jr) * ES + cq + 8 * (jm >> 1));
      mma16816(cb[0], a.x, a.y, a.z, a.w, e[0], e[1]);
      mma16816(cb[1], a.x, a.y, a.z, a.w, e[2], e[3]);
    }
  }
}

// dW1^T += bf16(dz1) . enc over the 16 cells cq..: A adz (hidden units x
// cells), B from the [channel][cell] tile, (channels 16 nc2 + 8 (jm >> 1)..,
// cells 8 (jm & 1)..).
template <int NKC>
__device__ __forceinline__ void dw1_step(float (&w1acc)[2 * NKC][4], const uint32_t (&adz)[4], const uint16_t* eb,
                                         const Dims& d, int cq, int jm, int jr) {
#pragma unroll
  for (int nc2 = 0; nc2 < NKC; ++nc2) {
    if (nc2 < d.nkc) {
      uint32_t e[4];
      ldsm4(e, eb + (16 * nc2 + 8 * (jm >> 1) + jr) * ES + cq + 8 * (jm & 1));
      mma16816(w1acc[2 * nc2], adz[0], adz[1], adz[2], adz[3], e[0], e[1]);
      mma16816(w1acc[2 * nc2 + 1], adz[0], adz[1], adz[2], adz[3], e[2], e[3]);
    }
  }
}

// bf16(dz1) of m-tile mt at the 16 cells cq.. to the hidden-major tile dzd
// [HP][ES] (dEnc's operand), from its A fragment.
__device__ __forceinline__ void store_dz(uint16_t* dzd, const uint32_t (&adz)[4], int mt, int cq, int g, int t) {
  uint32_t* p0 = reinterpret_cast<uint32_t*>(dzd + (16 * mt + g) * ES + cq + 2 * t);
  uint32_t* p8 = reinterpret_cast<uint32_t*>(dzd + (16 * mt + g + 8) * ES + cq + 2 * t);
  p0[0] = adz[0];
  p8[0] = adz[1];
  p0[4] = adz[2];
  p8[4] = adz[3];
}

// dEnc of the row w from dz1 in dzs [HP][ES]: cells on M (a warp's m-tiles
// warp, warp + 8), A by .trans of (hidden units 8 (jm >> 1).., cells
// 8 (jm & 1)..), B W1c^T's fragments w1b; stored to denc [.., LF, plane] at
// the row's z plane, at the cells on the grid.
template <int NKC>
__device__ __forceinline__ void denc_row(float* __restrict__ denc, const ngp::Row& w, const uint16_t* dzs,
                                         const uint2* w1b, const Dims& d, size_t plane, int nx, int ny) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, jr = lane & 7, nc8 = 2 * d.nkc, LF = d.LF;
  float* out = denc + (size_t)w.z * LF * plane;
  for (int mc = warp; mc < NT / 16; mc += NT / 32) {
    float acc[2 * NKC][4];
#pragma unroll
    for (int nc = 0; nc < 2 * NKC; ++nc)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[nc][v] = 0.f;
    for (int kh = 0; kh < d.nmt; ++kh) {
      uint32_t a[4];
      ldsm4_t(a, dzs + (16 * kh + 8 * (jm >> 1) + jr) * ES + 16 * mc + 8 * (jm & 1));
#pragma unroll
      for (int nc = 0; nc < 2 * NKC; ++nc) {
        if (nc < nc8) {
          const uint2 bw = w1b[(kh * nc8 + nc) * 32 + lane];
          mma16816(acc[nc], a[0], a[1], a[2], a[3], bw.x, bw.y);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = 16 * mc + g + 8 * half, cx = w.x0 + cl % TX, cy = w.y0 + cl / TX;
      if (cx < nx && cy < ny) {
#pragma unroll
        for (int nc = 0; nc < 2 * NKC; ++nc)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 8 * nc + 2 * t + j;
            if (nc < nc8 && c < LF) out[(size_t)c * plane + (size_t)cy * nx + cx] = acc[nc][2 * half + j];
          }
      }
    }
  }
}

// The block's head partials after the walk: each m-tile's cell splits
// through shared memory, then added in split order. red_h [S][HP][NV]:
// db1, (DTW: dtw1 = t1 db1 + e1,) dW2's 4 outputs (the lanes t < 2 hold
// outputs 2t, 2t + 1 of the C fragment's first leg, columns 0..3, lanes t
// + 2 the same outputs of its second leg, 4..7: they are added); red_w
// [S][HP][LFP] dW1^T, both overlaying rows that no thread reads any more.
// Writes dw1_part [LF][H] and head_part [H][NV] of the block.
template <int MPW, int NKC, bool DTW>
__device__ __forceinline__ void head_partials(float* red_h, const Owned<MPW>& ow, const float (&db1)[MPW][2],
                                              const float (&e1)[MPW][2], float t1, const float (&w2acc)[MPW][4],
                                              const float (&w1acc)[MPW][2 * NKC][4], const Dims& d,
                                              float* __restrict__ dw1_part, float* __restrict__ head_part) {
  constexpr int NV = DTW ? 6 : 5, OW = NV - 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, nc8 = 2 * d.nkc;
  float* red_w = red_h + d.S * d.HP() * NV;  // [S][HP][LFP]: dW1^T
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    if (!ow.own[i]) continue;
    const int base_row = ow.split * d.HP() + 16 * ow.mts[i] + g;
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      float vb = db1[i][hs], ve = e1[i][hs];
      vb += __shfl_xor_sync(0xffffffffu, vb, 1);
      if (DTW) ve += __shfl_xor_sync(0xffffffffu, ve, 1);
      vb += __shfl_xor_sync(0xffffffffu, vb, 2);
      if (DTW) ve += __shfl_xor_sync(0xffffffffu, ve, 2);
      if (t == 0) {
        red_h[(base_row + 8 * hs) * NV] = vb;
        if (DTW) red_h[(base_row + 8 * hs) * NV + 1] = fmaf(t1, vb, ve);
      }
    }
    float o4[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) o4[v] = __shfl_down_sync(0xffffffffu, w2acc[i][v], 2);
    if (t < 2) {
#pragma unroll
      for (int v = 0; v < 4; ++v) red_h[(base_row + 8 * (v >> 1)) * NV + OW + 2 * t + (v & 1)] = w2acc[i][v] + o4[v];
    }
#pragma unroll
    for (int nc = 0; nc < 2 * NKC; ++nc)
      if (nc < nc8) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          red_w[(base_row + 8 * (v >> 1)) * d.LFP() + 8 * nc + 2 * t + (v & 1)] = w1acc[i][nc][v];
      }
  }
  __syncthreads();  // head partials: the splits' partials in
  const size_t blk = blockIdx.x;
  const int LF = d.LF, H = d.H;
  for (int o = threadIdx.x; o < LF * H; o += NT) {
    const int c = o / H, h = o % H;
    float sum = 0.f;
    for (int sp = 0; sp < d.S; ++sp) sum += red_w[(sp * d.HP() + h) * d.LFP() + c];
    dw1_part[blk * LF * H + o] = sum;
  }
  for (int o = threadIdx.x; o < H * NV; o += NT) {
    float sum = 0.f;
    for (int sp = 0; sp < d.S; ++sp) sum += red_h[sp * d.HP() * NV + o];
    head_part[blk * H * NV + o] = sum;
  }
}

}  // namespace bfk
}  // namespace
