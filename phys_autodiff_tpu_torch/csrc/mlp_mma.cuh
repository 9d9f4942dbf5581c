// The bf16 tier of the tiled MLP core (mlp_head.cuh): layer 2 on the tensor
// cores, mma.sync with bf16 operands and float32 accumulation. Its forward
// (fwd_tile / fwd_rows / fields_chunk) is shared by K2 and K4's fields
// pass; K3 and K6 run forwards of their own in mega.cu and fit.cu with the
// same operands a value (ab_kstep's AB loads, W2's fragments of
// load_w2_frags), and K6's backward and K4's adjoint pass have walks of
// their own (fit.cu, mega_bwd.cu).
//
// What the tier computes (the TPU's bf16 tier, pallas/mlp.py:231-232,
// mega.py:155-170, mega_bwd.py:705-750, fit.py:128-190): layer 1 stays the
// float32 core's, a1 = max(AB + CD, 0) with one float32 add; then every
// operand of the three layer-2 contractions is rounded to bf16 (to nearest
// even) and the products are summed in float32 (the forward takes the max
// after the rounding, on bf16 pairs: the same values, as rounding is
// monotone and keeps 0):
//   y    = bf16(a1) . bf16(W2)            (K2, K3, K4's fields, K6)
//   dW2T = bf16(gy)^T . bf16(a1)          (K4, K6)
//   da1  = bf16(gy) . bf16(W2)^T          (K4, K6), dz1 = [a1 > 0] da1
// K2's bf16x3 splits W2 and a1 into bf16 hi + lo (lo = bf16(x - hi)) and
// adds hi.hi + lo.hi + hi.lo (pallas/mlp.py:233-235, 300-316).
//
// Fragments (PTX ISA, mma.m16n8k16 / m16n8k8 with .bf16; lane = 4 g + t):
//   A 16 x 16: {a0, a1, a2, a3} = rows g, g + 8, g, g + 8 x columns
//     2t + {0, 1}, 2t + {0, 1}, 2t + 8 + {0, 1}, 2t + 8 + {0, 1}
//   B 16 x 8:  {b0, b1} = rows (k) 2t + {0, 1}, 2t + 8 + {0, 1} x column g
//   C 16 x 8:  {c0, c1, c2, c3} = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
//   (m16n8k8: A {a0, a1} and B {b0} as the first half of the above.)
// A register holds two bf16, the lower column (or row) in the low 16 bits:
// pack2(lo, hi) = __floats2bfloat162_rn(lo, hi) (cvt.rn.bf16x2.f32 takes
// the HIGH element first; chip_smoke.py checks the packing on the card).
//
// Forward (cells on M): a warp takes 16 cells x 16 hidden units as one A
// fragment (a thread: cells g and g + 8, hidden units 2t + {0, 1, 8, 9}),
// W2 as the B fragment (16 hidden units x 8 outputs, 4 real; read from
// shared memory, 8 B a lane a k-step, pre-packed by load_w2_frags), one
// accumulator of 16 cells x 8 outputs per (row, slice). A thread loads AB
// at its two cells once a k-step for all of a group's rows and slices, so
// AB's reuse across rows and slices is the f32 core's; the four lanes of a
// cell read four hidden-unit planes, 32-byte sectors each. H pads to a
// multiple of 16 with zero AB, zero CD and zero weights (exact zeros). The
// result of a (cell, row, slice) is its own chain of k-steps from 0 in the
// same order whatever fragment row the cell sits in, so K2, K3 and K4 give
// a field value the same bits (K3's loss equals K2 -> K1's).
//
// Backward (hidden units on M, cells on N and K): see fit.cu (K6) and
// mega_bwd.cu (K4's adjoint pass).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mlp_head.cuh"

namespace {  // internal linkage: each kernel source has its own copy
namespace mma16 {

using mlph::NT;
using mlph::NW;
using mlph::TX;
using mlph::TY;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// The rows R of a forward group's accumulator type float (&)[R][S][4].
template <class A>
constexpr int rows_of = std::extent<std::remove_cv_t<std::remove_reference_t<A>>>::value;

// Two floats rounded to bf16 (to nearest even) in one register, lo in the
// low 16 bits.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack2(lo, hi) with each half replaced by max(half, 0): one bf16x2 max.
__device__ __forceinline__ uint32_t relu2(float lo, float hi) {
  const __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// bf16x3's low part of x: x - float(bf16(x)), exact in float32.
__device__ __forceinline__ float rest(float x) { return x - __bfloat162float(__float2bfloat16_rn(x)); }

// d += A B, m16n8k16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B, m16n8k8, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// ldmatrix (m8n8, b16): lanes 8 j .. 8 j + 7 give the row addresses of
// matrix j (16 bytes each); thread T gets, of matrix j, (row T / 4, columns
// 2 (T % 4), + 1), or with .trans (rows 2 (T % 4), + 1, column T / 4), the
// lower index in the low half. The x2 forms read lanes 0-15's addresses.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// (x2 by a shared-window address, for loops that step it themselves)
__device__ __forceinline__ void ldsm2_at(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm2_t_at(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  ldsm2_at(r, (unsigned)__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const void* p) {
  ldsm2_t_at(r, (unsigned)__cvta_generic_to_shared(p));
}

// AB of one k-step at one cell for this thread's four hidden units of an A
// fragment (h, h + 1, h + 8, h + 9 with h = 16 kb + 2t, fwd_tile's order):
// p points at AB[h] of the cell, one hidden unit a plane. A full k-step
// (every unit below H) loads all four; the last, partial one loads zeros
// past H.
__device__ __forceinline__ void ab_kstep(const float* __restrict__ p, size_t plane, int h, int H, bool full,
                                         float (&v)[4]) {
  const float* p8 = p + 8 * plane;
  if (full) {
    v[0] = __ldg(p), v[1] = __ldg(p + plane), v[2] = __ldg(p8), v[3] = __ldg(p8 + plane);
  } else {
    v[0] = h < H ? __ldg(p) : 0.f;
    v[1] = h + 1 < H ? __ldg(p + plane) : 0.f;
    v[2] = h + 8 < H ? __ldg(p8) : 0.f;
    v[3] = h + 9 < H ? __ldg(p8 + plane) : 0.f;
  }
}

// W2T [4][H] as layer 2's B fragments: w2f[kb * 32 + lane] = {b0, b1} of
// k-step kb (hidden units 16 kb + 2t + {0, 1} and + 8), output g; zero for
// g >= 4 and past H. LO: the low parts rest(W2) (bf16x3). 2 HP16 entries.
template <bool LO>
__device__ __forceinline__ void load_w2_frags(uint2* w2f, const float* __restrict__ w2t, int H, int HP16) {
  for (int i = threadIdx.x; i < 2 * HP16; i += NT) {
    const int g = (i & 31) >> 2, h = 16 * (i >> 5) + 2 * (i & 3);
    auto w = [&](int hh) {
      const float v = g < 4 && hh < H ? __ldg(w2t + g * H + hh) : 0.f;
      return LO ? rest(v) : v;
    };
    w2f[i] = make_uint2(pack2(w(h), w(h + 1)), pack2(w(h + 8), w(h + 9)));
  }
}

// ---- the forward ---------------------------------------------------------

// The forward of R rows and S slices of one 16-cell tile: acc[zl][s] gets,
// in C-fragment order (cells g, g + 8 x outputs 2t, 2t + 1), the sum over
// the k-steps of bf16(max(AB + CD, 0)) . bf16(W2) (X3: hi.hi + lo.hi +
// hi.lo). ab_lo / ab_hi point at AB of this thread's cells (rows g and
// g + 8 of the tile); cdv is a CD table: row zl's slice s of hidden unit h
// at cdv[h * stride + zl * rstride + s] (S = 3: an aligned float4 a row;
// S = 1 may start at any slice of a row).
template <int S, int R, bool X3>
__device__ __forceinline__ void fwd_tile(const float* __restrict__ ab_lo, const float* __restrict__ ab_hi,
                                         size_t plane, const uint2* w2f, const uint2* w2f_lo, const float* cdv,
                                         int stride, int rstride, int H, float (&acc)[R][S][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int zl = 0; zl < R; ++zl)
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[zl][s][k] = 0.f;
  const int nkb = (H + 15) >> 4;
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    int hs[4];
    float al[4], ah[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hs[j] = 16 * kb + 2 * t + (j & 1) + 8 * (j >> 1);
      const bool on = hs[j] < H;
      al[j] = on ? __ldg(ab_lo + hs[j] * plane) : 0.f;
      ah[j] = on ? __ldg(ab_hi + hs[j] * plane) : 0.f;
    }
    const uint2 w = w2f[kb * 32 + lane];
    uint2 wl = w;
    if constexpr (X3) wl = w2f_lo[kb * 32 + lane];
#pragma unroll
    for (int zl = 0; zl < R; ++zl) {
      float cv[4][S];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* row = cdv + hs[j] * stride + zl * rstride;
        if constexpr (S == 3) {  // an aligned row of the three slices
          const float4 q = *reinterpret_cast<const float4*>(row);
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int s = 0; s < S; ++s) cv[j][s] = qv[s];
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) cv[j][s] = row[s];
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[4], y[4];
        if constexpr (!X3) {
          // bf16(max(z, 0)) = max(bf16(z), 0) (rounding is monotone and keeps
          // 0): the ReLU runs on the packed pairs, one bf16x2 max for two.
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = al[j] + cv[j][s];
            y[j] = ah[j] + cv[j][s];
          }
          mma16816(acc[zl][s], relu2(x[0], x[1]), relu2(y[0], y[1]), relu2(x[2], x[3]), relu2(y[2], y[3]), w.x,
                   w.y);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = fmaxf(al[j] + cv[j][s], 0.f);
            y[j] = fmaxf(ah[j] + cv[j][s], 0.f);
          }
          mma16816(acc[zl][s], pack2(x[0], x[1]), pack2(y[0], y[1]), pack2(x[2], x[3]), pack2(y[2], y[3]), w.x,
                   w.y);
          const uint32_t l0 = pack2(rest(x[0]), rest(x[1])), l1 = pack2(rest(y[0]), rest(y[1]));
          const uint32_t l2 = pack2(rest(x[2]), rest(x[3])), l3 = pack2(rest(y[2]), rest(y[3]));
          mma16816(acc[zl][s], l0, l1, l2, l3, w.x, w.y);
          mma16816(acc[zl][s], pack2(x[0], x[1]), pack2(y[0], y[1]), pack2(x[2], x[3]), pack2(y[2], y[3]),
                   wl.x, wl.y);
        }
      }
    }
  }
}

// fwd_tile over rows zl .. n - 1 of a CD table in straight-line groups of R
// rows while they last, then of (R + 1) / 2, ..., 1 (as mlph::fwd_rest), each
// group handed to done(zl, acc).
template <int S, int R, bool X3, class Done>
__device__ __forceinline__ void fwd_rows(const float* ab_lo, const float* ab_hi, size_t plane, const uint2* w2f,
                                         const uint2* w2f_lo, const float* cdv, int stride, int rstride, int zl,
                                         int n, int H, Done& done) {
  for (; n - zl >= R; zl += R) {
    float acc[R][S][4];
    fwd_tile<S, R, X3>(ab_lo, ab_hi, plane, w2f, w2f_lo, cdv + zl * rstride, stride, rstride, H, acc);
    done(zl, acc);
  }
  if constexpr (R > 1)
    fwd_rows<S, (R + 1) / 2, X3>(ab_lo, ab_hi, plane, w2f, w2f_lo, cdv, stride, rstride, zl, n, H, done);
}

// The rows of a chunk (n <= ZF, ZF a power of two): one group of ZF rows
// for a whole chunk, else groups of ZF / 2, ZF / 4, ..., 1.
template <int S, int ZF, bool X3, class Done>
__device__ __forceinline__ void fwd_chunk(const float* ab_lo, const float* ab_hi, size_t plane, const uint2* w2f,
                                          const uint2* w2f_lo, const float* cdv, int stride, int rstride, int n,
                                          int H, Done&& done) {
  if (n == ZF) {
    fwd_rows<S, ZF, X3>(ab_lo, ab_hi, plane, w2f, w2f_lo, cdv, stride, rstride, 0, n, H, done);
  } else if constexpr (ZF > 1) {
    fwd_rows<S, ZF / 2, X3>(ab_lo, ab_hi, plane, w2f, w2f_lo, cdv, stride, rstride, 0, n, H, done);
  }
}

// The fields of a chunk's rows (K2 and K4's fields pass): warp w takes tile
// row y0 + w, as two 16-cell tiles (x0 + 16 m + g, + 8), and stores the
// outputs of its C fragments through the channel map (lanes t < 2 hold
// outputs 2t, 2t + 1). cd_s is the chunk's table [HP16][ZF + 1][P]: one
// padding row a hidden unit, so that the four lanes of a cell, which read
// the rows of hidden units 2t apart, meet distinct banks (at ZF P floats a
// unit their float4s met the same banks: 4-way conflicts, which cost K2's
// bf16 tier 45% on an H100).
template <int S, int ZF, int P, bool X3>
__device__ __forceinline__ void fields_chunk(const float* ab, const float* cd_s, const uint2* w2f,
                                             const uint2* w2f_lo, const float (&b2r)[4], const mlph::Chans& out,
                                             const mlph::Chunk& c, int nx, int ny, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int gy = c.y0 + warp;
  if (gy >= ny) return;  // warp-uniform
  const size_t plane = (size_t)nx * ny, rowc = (size_t)gy * nx;
  const float bo0 = t == 0 ? b2r[0] : b2r[2], bo1 = t == 0 ? b2r[1] : b2r[3];
  float* o0[S];
  float* o1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    o0[s] = t == 0 ? out.p[s * 4] : out.p[s * 4 + 2];
    o1[s] = t == 0 ? out.p[s * 4 + 1] : out.p[s * 4 + 3];
  }
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    const int xb = c.x0 + 16 * m;
    if (xb >= nx) break;  // warp-uniform
    const int xl = xb + g, xh = xb + g + 8;
    const float* ab_lo = ab + rowc + min(xl, nx - 1);
    const float* ab_hi = ab + rowc + min(xh, nx - 1);
    fwd_chunk<S, ZF, X3>(ab_lo, ab_hi, plane, w2f, w2f_lo, cd_s, (ZF + 1) * P, P, c.n, H,
                            [&](int zl0, const auto& acc) {
                              constexpr int R = rows_of<decltype(acc)>;
                              if (t >= 2) return;
#pragma unroll
                              for (int i = 0; i < R; ++i) {
                                const size_t at = (size_t)(c.z0 + zl0 + i) * plane + rowc;
#pragma unroll
                                for (int s = 0; s < S; ++s) {
                                  if (xl < nx) {
                                    o0[s][at + xl] = acc[i][s][0] + bo0;
                                    o1[s][at + xl] = acc[i][s][1] + bo1;
                                  }
                                  if (xh < nx) {
                                    o0[s][at + xh] = acc[i][s][2] + bo0;
                                    o1[s][at + xh] = acc[i][s][3] + bo1;
                                  }
                                }
                              }
                            });
  }
}

}  // namespace mma16
}  // namespace
