// K5: the NGP backward mega-kernel (the loss and every head / encoding
// gradient of the encoded-field model), sm_90a.
//
// Replaces _build_ngp_bwd_call of phys_autodiff_tpu/pallas/mega_ngp.py
// (:167). Inputs: the encoding enc [nz, LF, ny, nx], W1c = W1[:-1] [LF, H],
// tb1 = b1 + W1[-1] t_s [H, 3] and ts = t_s [3] (the slices t-dt, t, t+dt),
// W2 [H, 4], b2 [4]. Per cell the head is
//   base = W1c^T enc,  a1_s = relu(base + tb1[:, s]),  y_s = W2^T a1_s + b2,
// the 12 fields feed the transport residual and the loss. Outputs, as the
// JAX kernel's: the per-(z plane, tile) loss partials, dEnc [nz, LF, ny, nx]
// (skipped for a parameter-free encoding: denc == nullptr), dW1c [LF, H],
// db1 = sum_s sum dz1_s [H], dtw1 = sum_s t_s sum dz1_s [H] (W1's last row),
// dW2 [H, 4] and db2 [4]. The host pulls dEnc back to the encoder's
// parameters by autograd and takes d_t = W1[-1] . db1.
//
// Launches, and no float atomics: every sum has a fixed order, so the
// gradients are the same bits from run to run. Passes 1 and 3 run on a
// persistent grid of min(tile rows, 264) blocks, each walking a contiguous
// range of 32 x 8 tile rows (one whole wave at two blocks an SM).
//   1. the fields of the three slices to fbuf [12, nz, ny, nx] (t slice
//      first, so fbuf[0:4] is the [4, nz, ny, nx] the adjoint reads; K4
//      writes the same buffer in its own fields pass).
//   2. k_residuals<MODE_SCALED_PARTIALS> (residuals.cuh, K1's body): the
//      loss tile partials and g = (2w/N) R [4, nz, ny, nx].
//   3. the adjoint, per row: A, thread per cell, the stencil adjoint
//      (adjoint.cuh) gives the cotangents gy of the 12 fields (t slice: dF;
//      t -+ dt: -+ g/2dt); then the head's backward: base recomputed (the
//      [N, H] activations, 300 MB at the flagship, are never stored), dz1_s
//      = [a1_s > 0] W2 . gy_s, dz1_sum; db1, dtw1 and dW2 summed over every
//      row the block walks; (iii) dW1c += enc^T dz1_sum; (ii) dEnc =
//      dz1_sum W1c^T. The t -+ dt legs are 1/(2 dt) times larger than the t
//      slice's and nearly cancel, so, as in K4, they are added to each other
//      per cell first and never summed over the grid apart: dz1_sum = dz1_t
//      + (dz1_tm1 + dz1_tp1); dtw1 takes t dz1_sum + (dt_p dz1_tp1 - dt_m
//      dz1_tm1) (dt_m = t - t_0, dt_p = t_2 - t); dW2 takes a1_t dF +
//      (a1_tp1 - a1_tm1) g/2dt. (A float32 sum of each slice's a1 gy over
//      the grid loses about 1e-4 of dW2 to that cancellation, and a sum of
//      each slice's dz1 as much of db1.) Each block writes its partials.
//   4. k_sum_parts (ngp_head.cuh): the partials of dW1c, (db1, dtw1, dW2)
//      and db2, added in a fixed order.
//
// The compulsory DRAM traffic is the encoding read and dEnc write, 2 LF x
// 4 B a cell (151 MB at LF = 16 on 128x96x96, 0.045 ms at 3.35 TB/s). The
// head needs 6 LF H + 71 H operations a cell, an FMA counted as two: the
// base 2 LF H and 10 H a slice forward; backward W2 . gy for the t slice
// and t+dt (t-dt's is its negative) 16 H, the masks, the three slice sums
// and dz1_sum 8 H, dW2 17 H; dW1c and dEnc 2 LF H each. Of those, 6 LF H
// + 56 H are the products (chip_smoke.py's work tables); with the residual
// and its adjoint that is 13.0 GFLOP at the flagship.
//
// Tiers (pallas/mega_ngp.py:96-157, 202-219, 280-446):
//
// TIER_F32 runs the tiled head core of ngp_head.cuh (k_ngp_fields,
// k_ngp_adjoint<TPT, TIER_F32>; shared with K7) on FFMA: its bound is the
// FP32 operations (0.194 ms at 67 TFLOP/s), and every product feeds 8 to
// 16 FMAs from one shared load. Pass 3 recomputes pass 1's base and keeps
// it in registers; per row 3 barriers (A | (i) and B1 | (iii) | (ii)
// beside the next row's A and encoding copy).
//
// TIER_FASTBWD is the f32 function with a backward that rounds the
// recomputed base to bf16 before tb1_s is added (masks and a1 from it) and
// the encoding of (iii); da1, dW2, dz1_sum and dEnc stay float32 and no
// product uses tf32. Passes 1 and 2 are the f32 tier's (the loss is f32
// K5's to the bit) and pass 3 is the f32 walk with two changes: (iii) runs
// on the tensor cores as three exact bf16 products (dw1_rows_split: the
// encoding is rounded as its pairs are packed, and dz1_sum, float32, splits
// into hi + mid + lo bf16 parts whose products with a bf16 value are exact
// in float32, so only the accumulation differs from FFMA), and the
// encoding needs no rounding pass of its own (one barrier a row fewer).
// The base recompute, B1 and dEnc stay on FFMA with float32 operands, and
// bound the tier. (On the TPU the tier halved the VMEM traffic of carried
// base and encoding windows; this kernel carries none.)
//
// TIER_BF16 rounds every product's operands to bf16 and sums in float32:
// base = bf16(enc) bf16(W1c), y_s = bf16(a1_s) bf16(W2) + b2, da1 =
// bf16(W2) bf16(gy_s), dW2 += bf16(gy_s)^T bf16(a1_s), dW1 += bf16(enc)^T
// bf16(dz1_sum), dEnc = bf16(dz1_sum) bf16(W1c)^T; the masks, db1, dtw1,
// db2 and dz1_sum are float32 values and sums. Its bound is the bytes
// (0.045 ms; the tensor-core FLOP take 0.009 and the CUDA cores' share
// 0.040). Every product runs on mma.sync (m16n8k16 / m16n8k8, bf16 in,
// float32 accumulate; namespace bfk below, on the routines it shares with K7
// bf16 in ngp_mma.cuh):
//   pass 1 (k_ngp_fields_bf16): cells on M. A warp takes 32 cells; per 16
//     hidden units it forms base for them, adds tb1_s, takes the ReLU,
//     rounds to bf16 into the A fragment of layer 2 and accumulates y_s
//     (N = 8, 4 outputs real) in registers: base never leaves registers,
//     and the CUDA cores keep only the add, ReLU and pack.
//   pass 3 (k_ngp_adjoint_bf16): hidden units on M. A warp owns a 16-unit
//     tile of H (two, past H = 128) and a share of the row's cells; per 16
//     cells: base^T = W1c^T enc^T; da1^T for both legs as m16n8k8 over
//     [dF | g/2dt] (K = 8) with A = [W2 | 0] and [0 | W2]; B1 on the C
//     fragments in registers (adds, ReLUs, masks, dz1_sum, db1, e1); dW2 +=
//     [a1_t | a1_tp1 - a1_tm1] . [dF | g/2dt] with the difference (float32
//     from the rounded values) split exactly into three bf16 parts; dW1^T
//     += bf16(dz1_sum) . enc; the C fragments of two 8-cell tiles are the A
//     fragment of a 16-cell k-step, so none of these leaves registers. Only
//     dEnc (K = hidden units) needs dz1_sum transposed: it goes to shared
//     memory as bf16, hidden-major, and the next interval's (ii) reads it
//     with ldmatrix.trans.
//   Operands are packed once: W1c's and W2's fragments a block, before the
//   walk (shared memory, fragment order, one 8- or 16-byte load a lane);
//   the encoding row in bf16 as it arrives (thread per cell, channel-major
//   [channel][cell], read by ldmatrix for base (.trans) and dW1 (plain)),
//   read ahead as the walk below says.
//   The walk is pipelined (rather than warp-specialised: every warp takes
//   a share of each stage, so no producer warps sit idle when A is short,
//   and no mbarrier handshakes are needed): the row's encoding and gy are
//   double-buffered, and the interval of row r runs dEnc of row r - 1, the
//   products of row r and A of row r + 1, one barrier a row, with dz1_sum
//   double-buffered; where two dz1_sum buffers would cost the second block
//   an SM (large H), dEnc takes its own interval (two barriers). Row r + 1's
//   first 16 encoding channels are loaded into registers before row r's
//   products, so their latency hides behind them (both passes; pass 1 has
//   one barrier a row). The flagship LF = 16, H = 64 takes 21 KB of shared
//   memory in pass 1 and 97 KB in pass 3: two blocks an SM.
//
// The shard-local build (_build_ngp_bwd_call(nz_local=...), pallas/
// mega_ngp.py:167-190, 472-499): the caller encodes the global rows z0 - 2
// .. z0 + nz_local + 1, wrapped or clamped, into enc [nz_local + 4, LF, ny,
// nx]; passes 1 and 2 run on those rows as K4's shard-local build does
// (mega_bwd.cu), and pass 3 walks the owned rows, reading their encoding
// and fields two rows on (pat::ZRows), the clamp edges keyed on the global
// row z0 + i. dEnc comes out for the owned rows only, so each global row's
// cotangent is emitted once, by its owner; the caller pulls it back through
// the shard-local encoder and adds the shards' table gradients.

#include "adjoint.cuh"
#include "ngp_mma.cuh"
#include "residuals.cuh"

namespace {

using ngp::NCG;
using ngp::TM;

using ngp::Row;
using ngp::tile_row;

// Pass 1 of TIER_F32 and TIER_FASTBWD: the fields of the three slices. Per
// row: the encoding to shared memory, product (i) to base_s (the dz1 area),
// then thread per cell y_s = W2^T relu(base + tb1[:, s]) + b2 over the
// hidden units in order.
__global__ void __launch_bounds__(NT, 2)
    k_ngp_fields(const float* __restrict__ enc, const float* __restrict__ w1c,
                 const float* __restrict__ tb1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ fbuf, int nx, int ny, int nz,
                 int LF, int H, int ntx, int nrows) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const ngp::Shape s = ngp::make_shape(LF, H);
  const ngp::Smem m = ngp::layout(s, 0);
  ngp::load_weights(sh, s, m, w1c, w2);
  ngp::load_biases(sh, s, m, tb1, 3);
  const float4* w2_s = reinterpret_cast<const float4*>(sh + m.w2);
  const float4* tb_s = reinterpret_cast<const float4*>(sh + m.tb);
  float* enc_s = sh + m.enc;
  float* base_s = sh + m.dz;
  const int tid = threadIdx.x, hg = tid % s.nhg, sub = tid / s.nhg;
  const size_t plane = (size_t)nx * ny, ncell = (size_t)nz * plane;
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  ngp::zero_enc_rows(enc_s, s);
  __syncthreads();  // fields: weights in, encoding rows zeroed
  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  if (r0 < r1) {
    const Row w = tile_row(r0, ntx, nx, ny, nz);
    ngp::copy_enc_row(enc_s, s, enc, w.z, plane, (size_t)w.gy * nx + w.gx, w.valid);
  }
  for (int r = r0; r < r1; ++r) {
    const Row w = tile_row(r, ntx, nx, ny, nz);
    const size_t cell = w.valid ? (size_t)w.gy * nx + w.gx : 0;
    ngp::wait_enc_row();
    __syncthreads();  // fields: the row's encoding in; the last row's base read
    if (sub < s.tpg) {
      for (int cg = sub; cg < NCG; cg += s.tpg) {
        float b[TM][4];
        ngp::base_item(b, sh + m.w1, enc_s, s, cg, hg);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          *reinterpret_cast<float4*>(base_s + (cg + i * NCG) * s.HS + 4 * hg) =
              make_float4(b[i][0], b[i][1], b[i][2], b[i][3]);
      }
    }
    __syncthreads();  // fields: (i), base in; the encoding rows free for the next copy
    if (r + 1 < r1) {
      const Row wn = tile_row(r + 1, ntx, nx, ny, nz);
      ngp::copy_enc_row(enc_s, s, enc, wn.z, plane, (size_t)wn.gy * nx + wn.gx, wn.valid);
    }
    if (w.valid) {
      float acc[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 0; o < 4; ++o) acc[k][o] = 0.f;
      const float* brow = base_s + tid * s.HS;
      for (int h = 0; h < s.HP; h += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(brow + h);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 t = tb_s[h + j], wo = w2_s[h + j];
          const float tv[3] = {t.x, t.y, t.z};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float a = fmaxf(bv[j] + tv[k], 0.f);
            acc[k][0] = fmaf(a, wo.x, acc[k][0]);
            acc[k][1] = fmaf(a, wo.y, acc[k][1]);
            acc[k][2] = fmaf(a, wo.z, acc[k][2]);
            acc[k][3] = fmaf(a, wo.w, acc[k][3]);
          }
        }
      }
      // fbuf channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11 ([sigma, u]).
      const int slot[3] = {4, 0, 8};
      const size_t at = (size_t)w.z * plane + cell;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 0; o < 4; ++o) fbuf[(slot[k] + o) * ncell + at] = acc[k][o] + b2r[o];
    }
  }
}

// Two floats x0, x1 as three packed bf16 pairs with x = hi + mid + lo
// exactly (x0's parts in the low halves): each part keeps the top 8
// significant bits of what is left, truncated (so no part rounds up past
// the float32 range), and the subtractions are exact; a pair packs the
// upper halves of two floats in one byte permute. Exact for every finite
// x of magnitude 2^-110 or more; below that the bits under the least bf16
// subnormal (2^-133) drop.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(b0 & 0xffff0000u), r1 = x1 - __uint_as_float(b1 & 0xffff0000u);
  const uint32_t c0 = __float_as_uint(r0), c1 = __float_as_uint(r1);
  const float s0 = r0 - __uint_as_float(c0 & 0xffff0000u), s1 = r1 - __uint_as_float(c1 & 0xffff0000u);
  hi = __byte_perm(b0, b1, 0x7632);
  mid = __byte_perm(c0, c1, 0x7632);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

// Two neighbouring cells' (k, k + 1) float32 values at column n of a
// [cell][stride] shared tile, zero past `end` in n.
__device__ __forceinline__ float2 cell_pair(const float* m, int stride, int k, int n, int end) {
  return n < end ? make_float2(m[k * stride + n], m[(k + 1) * stride + n]) : make_float2(0.f, 0.f);
}

// Product (iii) of TIER_FASTBWD on the tensor cores: acc[i] += bf16(enc)^T
// dz1 over the row's NT cells for the warp's m16 x n8 tiles of dW1c (tile
// = warp + i NW = mt nnb + nb: channels 16 mt.., hidden units 8 nb..;
// ngp::mma_tiles_per_warp). The encoding is rounded to bf16 as its pairs are
// packed (the tier's rounding of (iii), read from the exact row that (i)
// read); dz1 (float32) enters as split3's three parts, three products a
// k-step, the small parts first.
template <int TPW>
__device__ __forceinline__ void dw1_rows_split(float (&acc)[TPW][4], const float* enc_s, const float* dz_s,
                                               const ngp::Shape& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nnb = (s.HP + 7) / 8, ntiles = ((s.LFP + 15) / 16) * nnb;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + i * (NT / 32);
    if (tile >= ntiles) break;
    const int c0 = 16 * (tile / nnb), n = 8 * (tile % nnb) + g;
#pragma unroll 2
    for (int k = 2 * t; k < NT; k += 16) {  // cells k, k + 1 and k + 8, k + 9 of each k-step
      uint32_t a[4], b0[3], b1[3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // A: (channels c0 + g, + 8) x (cells k.., k + 8..), rounded as packed
        const float2 e = cell_pair(enc_s, s.LFS, k + 8 * (j >> 1), c0 + g + 8 * (j & 1), s.LFP);
        a[j] = mma16::pack2(e.x, e.y);
      }
      const float2 d0 = cell_pair(dz_s, s.HS, k, n, s.HP), d1 = cell_pair(dz_s, s.HS, k + 8, n, s.HP);
      split3(d0.x, d0.y, b0[0], b0[1], b0[2]);
      split3(d1.x, d1.y, b1[0], b1[1], b1[2]);
#pragma unroll
      for (int part = 2; part >= 0; --part) mma16::mma16816(acc[i], a[0], a[1], a[2], a[3], b0[part], b1[part]);
    }
  }
}

// Pass 3 of TIER_F32 and TIER_FASTBWD (see the file comment). TPT: the
// (iii) tiles a thread owns (f32: 4 x 4 FFMA tiles, ngp::tiles_per_thread)
// or a warp owns (fastbwd: m16 x n8 mma tiles, ngp::mma_tiles_per_warp).
template <int TPT, int TIER>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_adjoint(const float* __restrict__ enc, const float* __restrict__ w1c,
                  const float* __restrict__ tb1, const float* __restrict__ ts,
                  const float* __restrict__ w2, const float* __restrict__ fbuf,
                  const float* __restrict__ gbuf, float* __restrict__ denc,
                  float* __restrict__ dw1_part, float* __restrict__ head_part,
                  float* __restrict__ db2_part, int nx, int ny, pat::ZRows zr, int LF, int H, int ntx,
                  int nrows, int periodic, pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  __shared__ float red2[2 * NT / 32];
  float* sh = reinterpret_cast<float*>(sh4);
  const ngp::Shape s = ngp::make_shape(LF, H);
  const ngp::Smem m = ngp::layout(s, 2);
  constexpr bool FB = TIER == ngp::TIER_FASTBWD;
  ngp::load_weights(sh, s, m, w1c, w2);
  ngp::load_biases(sh, s, m, tb1, 3);
  const float4* w2_s = reinterpret_cast<const float4*>(sh + m.w2);
  const float4* tb_s = reinterpret_cast<const float4*>(sh + m.tb);
  float4* gy_s = reinterpret_cast<float4*>(sh + m.gy);  // [NT][2]: dF_t, g / (2dt)
  float* enc_s = sh + m.enc;
  float* dz_s = sh + m.dz;
  const int tid = threadIdx.x, hg = tid % s.nhg, sub = tid / s.nhg;
  const size_t plane = (size_t)nx * ny;
  // t_0 = t - dt_m and t_2 = t + dt_p as the host rounded them.
  const float t1 = __ldg(ts + 1), dt_m = t1 - __ldg(ts), dt_p = __ldg(ts + 2) - t1;
  // B1's register sums of this thread's hidden units 4 hg + j: db1 =
  // sum dz1_sum, e1 = sum (dt_p dz1_tp1 - dt_m dz1_tm1), dW2.
  float db1[4] = {0.f, 0.f, 0.f, 0.f}, e1[4] = {0.f, 0.f, 0.f, 0.f}, dw2[4][4];
  // (iii)'s sums: TPT 4 x 4 tiles a thread (f32) or TPT m16 x n8 tiles a
  // warp, a quarter of each a thread (fastbwd)
  constexpr int NACC = FB ? 4 : 16;
  float acc[TPT][NACC], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 4; ++o) dw2[j][o] = 0.f;
#pragma unroll
  for (int t = 0; t < TPT; ++t)
#pragma unroll
    for (int v = 0; v < NACC; ++v) acc[t][v] = 0.f;

  ngp::zero_enc_rows(enc_s, s);
  __syncthreads();  // adjoint: weights in, encoding rows zeroed
  // the walk covers the owned rows (local z, dEnc's rows); their encoding
  // and fields lie hz rows further on in enc and the buffers (pat::ZRows)
  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  if (r0 < r1) {
    const Row w = tile_row(r0, ntx, nx, ny, zr.n);
    ngp::copy_enc_row(enc_s, s, enc, w.z + zr.hz, plane, (size_t)w.gy * nx + w.gx, w.valid);
  }
  for (int r = r0; r < r1; ++r) {
    const Row w = tile_row(r, ntx, nx, ny, zr.n);
    // ---- A: field cotangents (the row's encoding is on its way) ------------
    float4 gt = make_float4(0.f, 0.f, 0.f, 0.f), gq = gt;
    if (w.valid) {
      float d[4], gc[4];
      pat::t_slice_adjoint(fbuf, gbuf, w.gx, w.gy, w.z, nx, ny, zr, periodic, k, d, gc);
      gt = make_float4(d[0], d[1], d[2], d[3]);
      gq = make_float4(k.inv2dt * gc[0], k.inv2dt * gc[1], k.inv2dt * gc[2], k.inv2dt * gc[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) db[c] += d[c];
    }
    gy_s[tid * 2] = gt;      // gy of the t slice
    gy_s[tid * 2 + 1] = gq;  // gy of t+dt; t-dt's is its negative
    ngp::wait_enc_row();
    __syncthreads();  // adjoint: (ii) of the last row, A and the encoding of this one

    // ---- (i) and B1: base in registers, dz1_sum to shared memory ----------
    if (sub < s.tpg) {
      for (int cg = sub; cg < NCG; cg += s.tpg) {
        float b[TM][4];
        ngp::base_item(b, sh + m.w1, enc_s, s, cg, hg);
        if (FB) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) b[i][j] = ngp::bfr(b[i][j]);
        }
        float4 tbr[4], w2r[4];  // the item's hidden units, loaded once
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tbr[j] = tb_s[4 * hg + j];
          w2r[j] = w2_s[4 * hg + j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int cl = cg + i * NCG;
          const float4 f = gy_s[cl * 2], q = gy_s[cl * 2 + 1];  // zero off the grid
          float dz[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 tb = tbr[j], wr = w2r[j];
            const float am = fmaxf(b[i][j] + tb.x, 0.f);
            const float at = fmaxf(b[i][j] + tb.y, 0.f);
            const float ap = fmaxf(b[i][j] + tb.z, 0.f);
            const float pt = wr.x * f.x + wr.y * f.y + wr.z * f.z + wr.w * f.w;
            const float pq = wr.x * q.x + wr.y * q.y + wr.z * q.z + wr.w * q.w;
            const float dm = am > 0.f ? -pq : 0.f;
            const float dt = at > 0.f ? pt : 0.f;
            const float dp = ap > 0.f ? pq : 0.f;
            dz[j] = dt + (dm + dp);
            db1[j] += dz[j];
            e1[j] = fmaf(dt_p, dp, fmaf(-dt_m, dm, e1[j]));
            const float dif = ap - am;
            dw2[j][0] += at * f.x + dif * q.x;
            dw2[j][1] += at * f.y + dif * q.y;
            dw2[j][2] += at * f.z + dif * q.z;
            dw2[j][3] += at * f.w + dif * q.w;
          }
          *reinterpret_cast<float4*>(dz_s + cl * s.HS + 4 * hg) = make_float4(dz[0], dz[1], dz[2], dz[3]);
        }
      }
    }
    __syncthreads();  // adjoint: (i) and B1 (dz1_sum in)

    // ---- (iii) dW1c += enc^T dz1_sum; then the next row's encoding is
    // copied while (ii) computes dEnc of this one ------------------------------
    if constexpr (FB)
      dw1_rows_split<TPT>(acc, enc_s, dz_s, s);
    else
      ngp::dw1_row<TPT>(acc, enc_s, dz_s, s);
    __syncthreads();  // adjoint: (iii); enc_s free
    if (r + 1 < r1) {
      const Row wn = tile_row(r + 1, ntx, nx, ny, zr.n);
      ngp::copy_enc_row(enc_s, s, enc, wn.z + zr.hz, plane, (size_t)wn.gy * nx + wn.gx, wn.valid);
    }
    if (denc != nullptr) ngp::denc_row(denc + (size_t)w.z * LF * plane, plane, w.x0, w.y0, nx, ny, sh + m.w1, dz_s, s);
  }
  __syncthreads();  // adjoint: the last (ii), before the scratch overlays dz_s

  // ---- the block's partials -------------------------------------------------
  const size_t blk = blockIdx.x;
  float* red = sh + m.enc;
  if constexpr (FB)
    ngp::dw1_store_mma<TPT>(dw1_part + blk * LF * H, acc, s);
  else
    ngp::dw1_store<TPT>(dw1_part + blk * LF * H, acc, red, s);
  float vals[4][6];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    vals[j][0] = db1[j];
    vals[j][1] = fmaf(t1, db1[j], e1[j]);
#pragma unroll
    for (int o = 0; o < 4; ++o) vals[j][2 + o] = dw2[j][o];
  }
  ngp::head_store<6>(head_part + blk * H * 6, vals, red, s);
  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  pat::block_sum2<NT>(db[0], db[1], red2);
  __syncthreads();  // adjoint: red2 free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red2);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[blk * 4 + c] = db[c];
  }
}

// ---- TIER_BF16: passes 1 and 3 with every product on the tensor cores ------
namespace bfk {

// Pass 1's dynamic shared memory, byte offsets: W1c's fragments [nmt][nkc]
// [32] uint4 (load_w1a; k channels, n hidden units), W2's [nmt][32] uint2
// (k hidden units, n outputs), tb1 [HP] float4 (the slices), the encoding
// [2][LFP][ES] bf16 (two rows).
struct FieldsSmem {
  int w1f, w2f, tb, enc, total;
};

__host__ __device__ inline FieldsSmem fields_layout(const Dims& d) {
  FieldsSmem m;
  m.w1f = 0;
  m.w2f = m.w1f + d.nmt * d.nkc * 32 * 16;
  m.tb = m.w2f + d.nmt * 32 * 8;
  m.enc = m.tb + d.HP() * 16;
  m.total = m.enc + 2 * d.LFP() * ES * 2;
  return m;
}

// Pass 3's: W1c^T's A fragments [nmt][nkc][32] uint4 (m hidden units, k
// channels; base^T), W1c^T's B fragments [nmt][2 nkc][32] uint2 (k hidden
// units, n channels; dEnc), gy [2][NT] x 8 bf16 (dF_t, g / (2 dt)), the
// encoding [2][LFP][ES] bf16, bf16(dz1_sum) [ndz][HP][ES] (hidden-major).
// After the walk the splits' partial sums [S][HP][6 + LFP] float overlay
// gy onward.
struct AdjSmem {
  int w1a, w1b, gy, enc, dz, total;
};

__host__ __device__ inline AdjSmem adjoint_layout(const Dims& d, int ndz) {
  AdjSmem m;
  m.w1a = 0;
  m.w1b = m.w1a + d.nmt * d.nkc * 32 * 16;
  m.gy = m.w1b + d.nmt * 2 * d.nkc * 32 * 8;
  m.enc = m.gy + 2 * NT * 16;
  m.dz = m.enc + 2 * d.LFP() * ES * 2;
  const int rows = m.dz + ndz * d.HP() * ES * 2;
  const int red = m.gy + d.S * d.HP() * (6 + d.LFP()) * 4;
  m.total = rows > red ? rows : red;
  return m;
}

// dz1_sum's buffers: two (dEnc of a row beside the next row's products,
// one barrier a row) where that keeps as many blocks an SM as one does.
__host__ inline int adjoint_ndz(const Dims& d) {
  const int one = adjoint_layout(d, 1).total, two = adjoint_layout(d, 2).total;
  const int cap = ngp::SMEM_LIMIT - ngp::SMEM_STATIC;
  return two <= SMEM_2BLK || (one > SMEM_2BLK && two <= cap) ? 2 : 1;
}

__device__ __forceinline__ float slice(const float4& v, int s) { return s == 0 ? v.x : s == 1 ? v.y : v.z; }

// Pass 1 of TIER_BF16. A warp owns the row's cells 16 (warp + 8 mi) .. + 15
// (mi < 2); per 16 hidden units kh: base of its cells for them (two C
// fragments), + tb1_s, ReLU and bf16 as the A fragment of y_s += a1_s W2.
template <int NKC>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_fields_bf16(const float* __restrict__ enc, const float* __restrict__ w1c, const float* __restrict__ tb1,
                      const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ fbuf, int nx,
                      int ny, int nz, int LF, int H, int ntx, int nrows) {
  extern __shared__ float4 sh4[];
  char* sh = reinterpret_cast<char*>(sh4);
  const Dims d = make_dims(LF, H);
  const FieldsSmem m = fields_layout(d);
  uint4* w1f = reinterpret_cast<uint4*>(sh + m.w1f);
  uint2* w2f = reinterpret_cast<uint2*>(sh + m.w2f);
  float4* tb_s = reinterpret_cast<float4*>(sh + m.tb);
  uint16_t* encb = reinterpret_cast<uint16_t*>(sh + m.enc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, jr = lane & 7;  // ldmatrix: the matrix and row of this lane's address
  const int est = d.LFP() * ES;
  load_w1a(w1f, w1c, d);
  load_w2f(w2f, w2, d);
  for (int h = tid; h < d.HP(); h += NT)
    tb_s[h] = h < H ? make_float4(__ldg(tb1 + 3 * h), __ldg(tb1 + 3 * h + 1), __ldg(tb1 + 3 * h + 2), 0.f)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t plane = (size_t)nx * ny, ncell = (size_t)nz * plane;
  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  if (r0 < r1) {
    const Row w = tile_row(r0, ntx, nx, ny, nz);
    float v[16];
    enc_head(v, d, enc, w.z, plane, (size_t)w.gy * nx + w.gx, w.valid);
    enc_store(encb, v, d, enc, w.z, plane, (size_t)w.gy * nx + w.gx, w.valid);
  }
  __syncthreads();  // fields bf16: fragments and the first row's encoding in
  for (int r = r0; r < r1; ++r) {
    const int b = (r - r0) & 1;
    const Row w = tile_row(r, ntx, nx, ny, nz);
    const uint16_t* eb = encb + b * est;
    // the next row's encoding: its loads issued before this row's products
    const Row wn = tile_row(r + 1 < r1 ? r + 1 : r, ntx, nx, ny, nz);
    const size_t cn = (size_t)wn.gy * nx + wn.gx;
    float nxt[16];
    if (r + 1 < r1) enc_head(nxt, d, enc, wn.z, plane, cn, wn.valid);
    // A fragments of the warp's cells (rows) x channels (columns)
    uint32_t ea[2][NKC][4];
    fwd_enc_frags<NKC>(ea, eb, d, warp, jm, jr);
    float y[2][3][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int sl = 0; sl < 3; ++sl)
#pragma unroll
        for (int v = 0; v < 4; ++v) y[mi][sl][v] = 0.f;
    for (int kh = 0; kh < d.nmt; ++kh) {
      const int h0 = 16 * kh + 2 * t;  // this thread's hidden units h0, h0 + 1, h0 + 8, h0 + 9
      const float4 tb[4] = {tb_s[h0], tb_s[h0 + 1], tb_s[h0 + 8], tb_s[h0 + 9]};
      const uint2 wb = w2f[kh * 32 + lane];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float c0[4], c1[4];  // hidden units h0.., h0 + 8..
        fwd_base<NKC>(c0, c1, ea[mi], w1f, d, kh, lane);
#pragma unroll
        for (int sl = 0; sl < 3; ++sl) {
          const float u0 = slice(tb[0], sl), u1 = slice(tb[1], sl), u8 = slice(tb[2], sl), u9 = slice(tb[3], sl);
          mma16816(y[mi][sl], relu2(c0[0] + u0, c0[1] + u1), relu2(c0[2] + u0, c0[3] + u1),
                   relu2(c1[0] + u8, c1[1] + u9), relu2(c1[2] + u8, c1[3] + u9), wb.x, wb.y);
        }
      }
    }
    // y's C fragments: cells g, g + 8 x outputs 2t, 2t + 1 (t < 2 real);
    // fbuf channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11
    if (t < 2) {
      const int slot[3] = {4, 0, 8};
      const float bo[2] = {__ldg(b2 + 2 * t), __ldg(b2 + 2 * t + 1)};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int cl = 16 * (warp + 8 * mi) + g + 8 * half, cx = w.x0 + cl % TX, cy = w.y0 + cl / TX;
          if (cx < nx && cy < ny) {
            const size_t at = (size_t)w.z * plane + (size_t)cy * nx + cx;
#pragma unroll
            for (int sl = 0; sl < 3; ++sl)
#pragma unroll
              for (int j = 0; j < 2; ++j) fbuf[(slot[sl] + 2 * t + j) * ncell + at] = y[mi][sl][2 * half + j] + bo[j];
          }
        }
    }
    if (r + 1 < r1) enc_store(encb + (b ^ 1) * est, nxt, d, enc, wn.z, plane, cn, wn.valid);
    __syncthreads();  // fields bf16: the row's fields out, the next row's encoding in
  }
}

// Pass 3 of TIER_BF16 (see the file comment). MPW: the hidden-unit m-tiles
// a warp owns (1; 2 past H = 128, where each warp takes every cell);
// NKC: nkc_class. ndz: adjoint_ndz.
template <int MPW, int NKC>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_adjoint_bf16(const float* __restrict__ enc, const float* __restrict__ w1c, const float* __restrict__ tb1,
                       const float* __restrict__ ts, const float* __restrict__ w2, const float* __restrict__ fbuf,
                       const float* __restrict__ gbuf, float* __restrict__ denc, float* __restrict__ dw1_part,
                       float* __restrict__ head_part, float* __restrict__ db2_part, int nx, int ny, pat::ZRows zr,
                       int LF, int H, int ntx, int nrows, int periodic, pat::StencilConsts k, int ndz) {
  extern __shared__ float4 sh4[];
  __shared__ float red2[2 * NT / 32];
  char* sh = reinterpret_cast<char*>(sh4);
  const Dims d = make_dims(LF, H);
  const AdjSmem m = adjoint_layout(d, ndz);
  uint4* w1a = reinterpret_cast<uint4*>(sh + m.w1a);
  uint2* w1b = reinterpret_cast<uint2*>(sh + m.w1b);
  uint4* gy = reinterpret_cast<uint4*>(sh + m.gy);
  uint16_t* encb = reinterpret_cast<uint16_t*>(sh + m.enc);
  uint16_t* dzb = reinterpret_cast<uint16_t*>(sh + m.dz);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, jr = lane & 7;  // ldmatrix: the matrix and row of this lane's address
  const int est = d.LFP() * ES, dst = d.HP() * ES;
  const size_t plane = (size_t)nx * ny;
  auto W2 = [&](int h, int o) { return h < H && o >= 0 && o < 4 ? __ldg(w2 + 4 * h + o) : 0.f; };
  load_w1a(w1a, w1c, d);
  load_w1b(w1b, w1c, d);
  const Owned<MPW> ow = owned<MPW>(d, warp);
  // Per m-tile, in registers: da1's A fragments [W2 | 0] (pt) and [0 | W2]
  // (pq) of hidden units 16 mt + g (a0) and + 8 (a1), and their tb1.
  uint32_t wpt[MPW][2], wpq[MPW][2];
  float tbm[MPW][2][3];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const int h = 16 * ow.mts[i] + g + 8 * hs;
      wpt[i][hs] = t < 2 ? pack2(W2(h, 2 * t), W2(h, 2 * t + 1)) : 0u;
      wpq[i][hs] = t >= 2 ? pack2(W2(h, 2 * t - 4), W2(h, 2 * t - 3)) : 0u;
#pragma unroll
      for (int sl = 0; sl < 3; ++sl) tbm[i][hs][sl] = h < H ? __ldg(tb1 + 3 * h + sl) : 0.f;
    }
  // t_0 = t - dt_m and t_2 = t + dt_p as the host rounded them.
  const float t1 = __ldg(ts + 1), dt_m = t1 - __ldg(ts), dt_p = __ldg(ts + 2) - t1;
  // Register sums over every row: db1 and e1 = sum (dt_p dz1_tp1 - dt_m
  // dz1_tm1) of hidden units 16 mt + g (+ 8), over this thread's cells;
  // dW2's C fragment (outputs 0..3: a1_t dF, 4..7: the difference's);
  // dW1^T's C fragments (n: 8 channels each); db2.
  float db1[MPW][2], e1[MPW][2], w2acc[MPW][4], w1acc[MPW][2 * NKC][4], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      w2acc[i][v] = 0.f;
#pragma unroll
      for (int nc = 0; nc < 2 * NKC; ++nc) w1acc[i][nc][v] = 0.f;
    }
    db1[i][0] = db1[i][1] = e1[i][0] = e1[i][1] = 0.f;
  }

  // A: the field cotangents of row r (thread per cell; t slice dF, t + dt
  // g / (2 dt), rounded) and its encoding to buffer bb, whose first 16
  // channels the caller read ahead into v (enc_head of head_row(r)).
  auto head_row = [&](int r, float (&v)[16]) {
    const Row w = tile_row(r, ntx, nx, ny, zr.n);
    enc_head(v, d, enc, w.z + zr.hz, plane, (size_t)w.gy * nx + w.gx, w.valid);
  };
  auto stage_a = [&](int r, int bb, const float (&v)[16]) {
    const Row w = tile_row(r, ntx, nx, ny, zr.n);
    enc_store(encb + bb * est, v, d, enc, w.z + zr.hz, plane, (size_t)w.gy * nx + w.gx, w.valid);
    float gt[4] = {0.f, 0.f, 0.f, 0.f}, gq[4] = {0.f, 0.f, 0.f, 0.f};
    if (w.valid) {
      float gc[4];
      pat::t_slice_adjoint(fbuf, gbuf, w.gx, w.gy, w.z, nx, ny, zr, periodic, k, gt, gc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gq[c] = k.inv2dt * gc[c];
        db[c] += gt[c];
      }
    }
    gy[bb * NT + tid] = make_uint4(pack2(gt[0], gt[1]), pack2(gt[2], gt[3]), pack2(gq[0], gq[1]), pack2(gq[2], gq[3]));
  };

  // The products of the row in buffer bb (see the file comment); dz1_sum
  // to dzd as bf16 when dEnc is wanted.
  auto products = [&](int bb, uint16_t* dzd) {
    const uint16_t* eb = encb + bb * est;
    const uint4* gyb = gy + bb * NT;
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (!ow.own[i]) continue;
      const int mt = ow.mts[i];
      for (int q = ow.q0; q < ow.q1; ++q) {
        const int cq = 16 * q;
        // base^T (hidden units x the 16 cells, two n8 tiles): B from the
        // [channel][cell] tile, .trans of (channels 8 (jm & 1).., cells 8 (jm >> 1)..)
        float cb[2][4];
        base_t<NKC>(cb, w1a, eb, d, mt, cq, lane, jm, jr);
        // gy of the 16 cells: as da1's B (k outputs, n cells) and, .trans,
        // as dW2's (k cells, n outputs)
        uint32_t gb[2], gk[2];
        ldsm2(gb, gyb + cq + (lane & 15));
        ldsm2_t(gk, gyb + cq + (lane & 15));
        float pt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float pq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma1688(pt[n], wpt[i][0], wpt[i][1], gb[n]);
          mma1688(pq[n], wpq[i][0], wpq[i][1], gb[n]);
        }
        // B1 on the C fragments: v = 2 hs + j is hidden unit 16 mt + g + 8 hs
        // at cell cq + 8 n + 2 t + j
        float dz[2][4], at[2][4], df[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int hs = v >> 1;
            const float bv = cb[n][v];
            const float am = fmaxf(bv + tbm[i][hs][0], 0.f);
            const float a1t = fmaxf(bv + tbm[i][hs][1], 0.f);
            const float ap = fmaxf(bv + tbm[i][hs][2], 0.f);
            const float p = pt[n][v], qv = pq[n][v];
            const float dm = am > 0.f ? -qv : 0.f;
            const float dtv = a1t > 0.f ? p : 0.f;
            const float dp = ap > 0.f ? qv : 0.f;
            dz[n][v] = dtv + (dm + dp);
            db1[i][hs] += dz[n][v];
            e1[i][hs] = fmaf(dt_p, dp, fmaf(-dt_m, dm, e1[i][hs]));
            at[n][v] = a1t;
            // the difference of two bf16 values, exact in float32 but for
            // far apart exponents
            df[n][v] = ngp::bfr(ap) - ngp::bfr(am);
          }
        // A fragments over the 16 cells: a0 = (g, cells 2t..), a1 = (g + 8,
        // ..), a2, a3 the same of cells 8 + 2t..: C's (n = k >> 1, v = 2 (k & 1) ..)
        uint32_t aat[4], adz[4], adf[3][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int n = kk >> 1, v = 2 * (kk & 1);
          aat[kk] = pack2(at[n][v], at[n][v + 1]);
          adz[kk] = pack2(dz[n][v], dz[n][v + 1]);
          split3(df[n][v], df[n][v + 1], adf[0][kk], adf[1][kk], adf[2][kk]);
        }
        // dW2: a1_t . dF into outputs 0..3, the difference . g/(2 dt) into
        // 4..7 (B's other half zero)
        const bool lo4 = g < 4;
        const uint32_t f0 = lo4 ? gk[0] : 0u, f1 = lo4 ? gk[1] : 0u, q0b = lo4 ? 0u : gk[0], q1b = lo4 ? 0u : gk[1];
        mma16816(w2acc[i], aat[0], aat[1], aat[2], aat[3], f0, f1);
#pragma unroll
        for (int part = 2; part >= 0; --part)
          mma16816(w2acc[i], adf[part][0], adf[part][1], adf[part][2], adf[part][3], q0b, q1b);
        // dW1^T += bf16(dz1_sum) . enc
        dw1_step<NKC>(w1acc[i], adz, eb, d, cq, jm, jr);
        if (dzd != nullptr) store_dz(dzd, adz, mt, cq, g, t);  // bf16(dz1_sum) for dEnc, hidden-major
      }
    }
  };

  // (ii) dEnc of row r from dz1_sum in dzs
  auto denc_of = [&](int r, const uint16_t* dzs) {
    denc_row<NKC>(denc, tile_row(r, ntx, nx, ny, zr.n), dzs, w1b, d, plane, nx, ny);
  };

  // The walk over the owned rows (local z; their encoding and fields lie hz
  // rows further on, pat::ZRows).
  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  const bool want = denc != nullptr;
  if (r0 < r1) {
    float v[16];
    head_row(r0, v);
    stage_a(r0, 0, v);
  }
  __syncthreads();  // adjoint bf16: fragments, the first row's gy and encoding in
  for (int r = r0; r < r1; ++r) {
    const int bb = (r - r0) & 1;
    float nxt[16];  // the next row's encoding: its loads issued before this interval's products
    if (r + 1 < r1) head_row(r + 1, nxt);
    if (ndz == 2 && want && r > r0) denc_of(r - 1, dzb + (bb ^ 1) * dst);
    products(bb, want ? dzb + (ndz == 2 ? bb : 0) * dst : nullptr);
    if (r + 1 < r1) stage_a(r + 1, bb ^ 1, nxt);
    __syncthreads();  // adjoint bf16: the row's products, the next row's A and encoding, dEnc of the row before
    if (ndz == 1 && want) {
      denc_of(r, dzb);
      __syncthreads();  // adjoint bf16: dEnc of the row (one dz1_sum buffer)
    }
  }
  if (ndz == 2 && want && r1 > r0) denc_of(r1 - 1, dzb + ((r1 - 1 - r0) & 1) * dst);
  __syncthreads();  // adjoint bf16: the last dEnc, before the scratch overlays the rows

  // ---- the block's partials: each m-tile's splits through shared memory --
  head_partials<MPW, NKC, true>(reinterpret_cast<float*>(sh + m.gy), ow, db1, e1, t1, w2acc, w1acc, d, dw1_part,
                                head_part);
  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  pat::block_sum2<NT>(db[0], db[1], red2);
  __syncthreads();  // adjoint bf16: red2 free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red2);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[(size_t)blockIdx.x * 4 + c] = db[c];
  }
}

// Launch pass 1 or 3 of TIER_BF16 for the shape's NKC (and MPW).
template <int NKC>
cudaError_t launch_fields(const float* enc, const float* w1c, const float* tb1, const float* w2, const float* b2,
                          float* fbuf, int nx, int ny, int nz, int LF, int H, int ntx, int nrows, int nblk,
                          size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_fields_bf16<NKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_fields_bf16<NKC><<<nblk, NT, smem, s>>>(enc, w1c, tb1, w2, b2, fbuf, nx, ny, nz, LF, H, ntx, nrows);
  return cudaGetLastError();
}

template <int MPW, int NKC>
cudaError_t launch_adjoint(const float* enc, const float* w1c, const float* tb1, const float* ts, const float* w2,
                           const float* fbuf, const float* gbuf, float* denc, float* dw1_part, float* head_part,
                           float* db2_part, int nx, int ny, pat::ZRows zr, int LF, int H, int ntx, int nrows,
                           int nblk, int periodic, const pat::StencilConsts& k, int ndz, size_t smem,
                           cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_adjoint_bf16<MPW, NKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_adjoint_bf16<MPW, NKC><<<nblk, NT, smem, s>>>(enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part,
                                                       db2_part, nx, ny, zr, LF, H, ntx, nrows, periodic, k, ndz);
  return cudaGetLastError();
}

}  // namespace bfk

template <int TPT, int TIER>
cudaError_t launch_adjoint(const float* enc, const float* w1c, const float* tb1, const float* ts,
                           const float* w2, const float* fbuf, const float* gbuf, float* denc,
                           float* dw1_part, float* head_part, float* db2_part, int nx, int ny,
                           pat::ZRows zr, int LF, int H, int ntx, int nrows, int nblk, int periodic,
                           const pat::StencilConsts& k, size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_adjoint<TPT, TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_adjoint<TPT, TIER><<<nblk, NT, smem, s>>>(enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part,
                                                  head_part, db2_part, nx, ny, zr, LF, H, ntx, nrows, periodic, k);
  return cudaGetLastError();
}

// tpt: (iii)'s tiles a thread (f32: 1 or 2) or a warp (fastbwd: 1, 2, 4 or
// 8; ngp_head.cuh mma_tiles_per_warp).
template <int TIER>
cudaError_t launch_adjoint_tpt(int tpt, const float* enc, const float* w1c, const float* tb1, const float* ts,
                               const float* w2, const float* fbuf, const float* gbuf, float* denc,
                               float* dw1_part, float* head_part, float* db2_part, int nx, int ny,
                               pat::ZRows zr, int LF, int H, int ntx, int nrows, int nblk, int periodic,
                               const pat::StencilConsts& k, size_t smem, cudaStream_t s) {
#define PAT_NGP_ARGS                                                                          \
  enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part, db2_part, nx, ny, zr, LF, H, ntx, \
      nrows, nblk, periodic, k, smem, s
  if (tpt == 1) return launch_adjoint<1, TIER>(PAT_NGP_ARGS);
  if (tpt == 2) return launch_adjoint<2, TIER>(PAT_NGP_ARGS);
  if constexpr (TIER == ngp::TIER_FASTBWD) {
    if (tpt == 4) return launch_adjoint<4, TIER>(PAT_NGP_ARGS);
    if (tpt == 8) return launch_adjoint<8, TIER>(PAT_NGP_ARGS);
  }
  return cudaErrorInvalidValue;
#undef PAT_NGP_ARGS
}

}  // namespace

// enc [NB, LF, ny, nx], W1c [LF, H], tb1 [H, 3], ts [3], W2 [H, 4], b2 [4];
// the rows [z0, z0 + nz_local) of the global nz: the whole grid (z0 = 0,
// nz_local = nz, NB = nz), or a shard's, whose enc holds the global rows
// z0 - 2 .. z0 + nz_local + 1 wrapped or clamped (NB = nz_local + 4,
// pat::ZRows); dEnc [nz_local, LF, ny, nx] covers the owned rows;
// scratch fbuf [12, NB ny nx], gbuf [4, NB ny nx], tile partials [2, NB, ntiles], dW1c
// partials [nblk, LF, H], (db1, dtw1, dW2) partials [nblk, H, 6], db2
// partials [nblk, 4]; outputs dEnc (or null), dW1c [LF, H], dhead [H, 6] =
// (db1, dtw1, dW2) side by side, db2 [4]. nblk = min(ntiles nz_local, NBLK) (the
// host computes it); LF <= 64, H <= 256 and the f32 adjoint pass's shared
// memory within a block's (the host gates; every tier's layout fits where
// that one does); tier: TIER_F32, TIER_BF16 or TIER_FASTBWD.
extern "C" int pat_mega_ngp(const float* enc, const float* w1c, const float* tb1, const float* ts,
                            const float* w2, const float* b2, float* fbuf, float* gbuf,
                            float* tile_parts, float* dw1_part, float* head_part, float* db2_part, float* denc,
                            float* dw1c, float* dhead, float* db2, int nx, int ny, int nz, int z0,
                            int nz_local, int LF, int H, int nblk, int periodic, int upwind, float inv2dt, float inv2hx,
                            float inv2hy, float inv2hz, float scale_sigma, float scale_u, int tier,
                            void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  cudaStream_t s = (cudaStream_t)stream;
  const ngp::Shape sh = ngp::make_shape(LF, H);
  const bfk::Dims bd = bfk::make_dims(LF, H);
  // the whole grid (hz = 0), or a shard's rows with two halo rows a side
  const pat::ZRows zr{z0, nz_local, nz, nz_local == nz ? 0 : 2};
  const int nb = zr.nb();
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz_local;
  const bool bf = tier == ngp::TIER_BF16;
  const int ndz = bf ? bfk::adjoint_ndz(bd) : 0;
  const size_t smem1 = bf ? bfk::fields_layout(bd).total : ngp::layout(sh, 0).total * sizeof(float);
  const size_t smem3 = bf ? bfk::adjoint_layout(bd, ndz).total : ngp::layout(sh, 2).total * sizeof(float);
  const size_t cap = ngp::SMEM_LIMIT - ngp::SMEM_STATIC;
  if (LF < 1 || LF > 64 || H < 1 || H > 256 || ngp::layout(sh, 2).total * sizeof(float) > cap || smem1 > cap ||
      smem3 > cap || nblk < 1 || nblk != (nrows < ngp::NBLK ? nrows : ngp::NBLK) || tier < ngp::TIER_F32 ||
      tier > ngp::TIER_FASTBWD || nz_local < 1 || z0 < 0 || z0 + nz_local > nz || (zr.hz == 0 && z0 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t ncell = (size_t)nb * ny * nx;
  const int nrows_f = ntx * nty * nb;  // the fields pass walks every buffer row
  cudaError_t err;

  // pass 1: TIER_FASTBWD's forward is the f32 tier's
  if (bf) {
    const int nkc = bfk::nkc_class(bd);
#define PAT_NGP_ARGS enc, w1c, tb1, w2, b2, fbuf, nx, ny, nb, LF, H, ntx, nrows_f, nblk, smem1, s
    err = nkc == 1 ? bfk::launch_fields<1>(PAT_NGP_ARGS)
          : nkc == 2 ? bfk::launch_fields<2>(PAT_NGP_ARGS)
                     : bfk::launch_fields<4>(PAT_NGP_ARGS);
#undef PAT_NGP_ARGS
  } else {
    cudaFuncSetAttribute(k_ngp_fields, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    k_ngp_fields<<<nblk, NT, smem1, s>>>(enc, w1c, tb1, w2, b2, fbuf, nx, ny, nb, LF, H, ntx, nrows_f);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;

  // K1's channel order (PACKED_ORDER) over fbuf's slots: t 0..3, t-dt 4..7,
  // t+dt 8..11.
  const float* f = fbuf;
  const FieldPtrs fp{{f + 4 * ncell, f, f + 8 * ncell, f + 5 * ncell, f + 6 * ncell, f + 7 * ncell,
                      f + ncell, f + 2 * ncell, f + 3 * ncell, f + 9 * ncell, f + 10 * ncell,
                      f + 11 * ncell}};
  const OutPtrs op{{gbuf, gbuf + ncell, gbuf + 2 * ncell, gbuf + 3 * ncell}};
  // over every buffer row, as K4 (mega_bwd.cu)
  k_residuals<MODE_SCALED_PARTIALS><<<dim3(ntx, nty, nb), NT, 0, s>>>(
      fp, op, tile_parts, nx, ny, nb, periodic, k, scale_sigma, scale_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (bf) {
    const int nkc = bfk::nkc_class(bd);
#define PAT_NGP_ARGS                                                                                         \
  enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part, db2_part, nx, ny, zr, LF, H, ntx, nrows, nblk, \
      periodic, k, ndz, smem3, s
    if (bd.nmt > 8)
      err = nkc == 1 ? bfk::launch_adjoint<2, 1>(PAT_NGP_ARGS)
            : nkc == 2 ? bfk::launch_adjoint<2, 2>(PAT_NGP_ARGS)
                       : bfk::launch_adjoint<2, 4>(PAT_NGP_ARGS);
    else
      err = nkc == 1 ? bfk::launch_adjoint<1, 1>(PAT_NGP_ARGS)
            : nkc == 2 ? bfk::launch_adjoint<1, 2>(PAT_NGP_ARGS)
                       : bfk::launch_adjoint<1, 4>(PAT_NGP_ARGS);
#undef PAT_NGP_ARGS
  } else {
#define PAT_NGP_ARGS                                                                          \
  enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part, db2_part, nx, ny, zr, LF, H, ntx, nrows, nblk, \
      periodic, k, smem3, s
    err = tier == ngp::TIER_FASTBWD ? launch_adjoint_tpt<ngp::TIER_FASTBWD>(ngp::mma_tiles_per_warp(sh), PAT_NGP_ARGS)
                                    : launch_adjoint_tpt<ngp::TIER_F32>(ngp::tiles_per_thread(sh), PAT_NGP_ARGS);
#undef PAT_NGP_ARGS
  }
  if (err != cudaSuccess) return (int)err;

  ngp::k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<H * 6, NT, 0, s>>>(head_part, dhead, H * 6, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return (int)cudaGetLastError();
}
