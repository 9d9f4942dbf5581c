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
// gradients are the same bits from run to run. Passes 1 and 3 run on the
// tiled head core of ngp_head.cuh (shared with K7), on a persistent grid
// of min(tile rows, 264) blocks, each walking a contiguous range of 32 x 8
// tile rows (one whole wave at two blocks an SM; the flagship LF = 16,
// H = 64 takes 94 KB of shared memory in pass 1 and 102 KB in pass 3).
//   1. k_ngp_fields: per row, the encoding to shared memory (cp.async,
//      issued while the row before finishes), product (i) of the core
//      (base, 4 cells x 4 hidden units a thread) to shared memory, then
//      thread per cell the three slices' y_s = W2^T
//      relu(base + tb1[:, s]) + b2 to fbuf [12, nz, ny, nx] (t slice first,
//      so fbuf[0:4] is the [4, nz, ny, nx] the adjoint reads; K4 writes
//      the same buffer in its own fields pass).
//   2. k_residuals<MODE_SCALED_PARTIALS> (residuals.cuh, K1's body): the
//      loss tile partials and g = (2w/N) R [4, nz, ny, nx].
//   3. k_ngp_adjoint, per row:
//      A  thread per cell: the stencil adjoint (adjoint.cuh) gives the
//         cotangents gy of the 12 fields (t slice: dF; t -+ dt: -+ g/2dt);
//         dF and g/2dt go to shared memory, where the row's encoding
//         arrives by cp.async, issued during the row before.
//      (i) + B1 per head item: base in registers (the [N, H] activations,
//         300 MB at the flagship, are never stored), then dz1_s = [a1_s >
//         0] W2 . gy_s; db1, dtw1 and dW2 accumulate in registers over
//         every row; dz1_sum goes to shared memory. The t -+ dt legs are
//         1/(2 dt) times larger than the t slice's and nearly cancel, so,
//         as in K4, they are added to each other per cell first and never
//         summed over the grid apart: dz1_sum = dz1_t + (dz1_tm1 +
//         dz1_tp1); dtw1 takes t dz1_sum + (dt_p dz1_tp1 - dt_m dz1_tm1)
//         (dt_m = t - t_0, dt_p = t_2 - t); dW2 takes a1_t dF + (a1_tp1 -
//         a1_tm1) g/2dt. (A float32 sum of each slice's a1 gy over the grid
//         loses about 1e-4 of dW2 to that cancellation, and a sum of each
//         slice's dz1 as much of db1.)
//      (iii) dW1c += enc^T dz1_sum in registers; then the next row's
//         encoding copy is issued and (ii) computes dEnc of this row.
//      Each block writes its partials (its splits and threads added in a
//      fixed order).
//   4. k_sum_parts (ngp_head.cuh): the partials of dW1c, (db1, dtw1, dW2)
//      and db2, added in a fixed order.
//
// Bound on this card: FP32 operations (the products run FFMA on the CUDA
// cores; no tensor cores, so the f32 tier holds by construction). The
// compulsory DRAM traffic is the encoding read and dEnc write, 2 LF x 4 B
// a cell (151 MB at LF = 16 on 128x96x96, 0.045 ms at 3.35 TB/s). The
// head needs 6 LF H + 71 H operations a cell, an FMA counted as two: the
// base 2 LF H and 10 H a slice forward; backward W2 . gy for the t slice
// and t+dt (t-dt's is its negative) 16 H, the masks, the three slice sums
// and dz1_sum 8 H, dW2 17 H; dW1c and dEnc 2 LF H each. With the residual
// and its adjoint that is 13.0 GFLOP there, 0.194 ms at 67 TFLOP/s
// (chip_smoke.py's work table). Pass 3 recomputes the base of pass 1
// (2 LF H a cell more than the bound counts) rather than store 300 MB.
// What the design does about the bound: every product feeds 8 to 16 FMAs
// from one shared load (the thread-per-cell loops of the first version fed
// one or two, which capped them near 1/4 of the FP32 rate), and the grid
// is one whole wave.
//
// Tiers (TIER, ngp_head.cuh; pallas/mega_ngp.py:96-157, 202-219, 280-446):
// TIER_BF16 runs base = bf16(enc) bf16(W1c) (pass 1 and pass 3's recompute
// one routine, base_rows_mma, so the same bits), dEnc = bf16(dz1_sum)
// bf16(W1c)^T and dW1 += bf16(enc)^T bf16(dz1_sum) on the tensor cores
// (mma.sync; pass 3 reads the base items back from shared memory, one more
// barrier a row), and on the CUDA cores y_s = bf16(a1_s) bf16(W2) + b2, da1
// = bf16(W2) bf16(gy_s) and dW2 += bf16(gy_s)^T bf16(a1_s) with W2 and gy_s
// (dF and g/2dt) rounded as they enter shared memory and a1_s where it is
// formed; the masks come from the float32 a1_s, db1, dtw1, db2 and dz1_sum
// are float32 sums, and the residual pass is K1's float32 body.
// TIER_FASTBWD runs pass 1 and 2 as the f32 tier does (the loss is f32
// K5's to the bit); pass 3 rounds the recomputed base to bf16 before tb1_s
// is added (masks and a1 from it) and rounds the encoding rows in place for
// (iii), one more barrier a row; da1, dW2, dz1_sum and dEnc stay float32.
// On the TPU that tier halves the VMEM traffic of the carried base and
// encoding windows; this kernel carries no windows (pass 3 recomputes the
// base), so the tier is no cheaper here than f32: it is the function,
// ported.
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
#include "ngp_head.cuh"
#include "residuals.cuh"

namespace {

using ngp::NCG;
using ngp::TM;

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

// Pass 1: the fields of the three slices. Per row: the encoding to shared
// memory, product (i) to base_s (the dz1 area), then thread per cell
// y_s = W2^T relu(base + tb1[:, s]) + b2 over the hidden units in order.
// BF: TIER_BF16 (product (i) on the tensor cores; W2 and a1_s rounded).
template <bool BF>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_fields(const float* __restrict__ enc, const float* __restrict__ w1c,
                 const float* __restrict__ tb1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ fbuf, int nx, int ny, int nz,
                 int LF, int H, int ntx, int nrows) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const ngp::Shape s = ngp::make_shape(LF, H);
  const ngp::Smem m = ngp::layout(s, 0);
  ngp::load_weights(sh, s, m, w1c, w2, BF);
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
    if (BF) {
      ngp::base_rows_mma(base_s, enc_s, sh + m.w1, s);
    } else if (sub < s.tpg) {
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
            const float a = BF ? ngp::bfr(fmaxf(bv[j] + tv[k], 0.f)) : fmaxf(bv[j] + tv[k], 0.f);
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

// Pass 3 (see the file comment). TPT: dW1c tiles a thread owns in (iii);
// TIER: the arithmetic (ngp_head.cuh).
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
  constexpr bool BF = TIER == ngp::TIER_BF16;
  ngp::load_weights(sh, s, m, w1c, w2, BF);
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
  // (iii)'s sums: TPT 4 x 4 tiles a thread (f32, fastbwd) or TPT m16 x n8
  // tiles a warp, a quarter of each a thread (bf16)
  constexpr int NACC = BF ? 4 : 16;
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
    gy_s[tid * 2] = BF ? ngp::bfr4(gt) : gt;      // gy of the t slice
    gy_s[tid * 2 + 1] = BF ? ngp::bfr4(gq) : gq;  // gy of t+dt; t-dt's is its negative
    ngp::wait_enc_row();
    __syncthreads();  // adjoint: (ii) of the last row, A and the encoding of this one
    if (BF) {  // (i) on the tensor cores, base to the dz1 area
      ngp::base_rows_mma(dz_s, enc_s, sh + m.w1, s);
      __syncthreads();  // adjoint: (i), base in (bf16)
    }

    // ---- (i) and B1: base in registers (bf16: from shared memory), dz1_sum
    // to shared memory (over the item's base) ---------------------------------
    if (sub < s.tpg) {
      for (int cg = sub; cg < NCG; cg += s.tpg) {
        float b[TM][4];
        if (BF) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(dz_s + (cg + i * NCG) * s.HS + 4 * hg);
            b[i][0] = v.x;
            b[i][1] = v.y;
            b[i][2] = v.z;
            b[i][3] = v.w;
          }
        } else {
          ngp::base_item(b, sh + m.w1, enc_s, s, cg, hg);
        }
        if (TIER == ngp::TIER_FASTBWD) {
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
            // dW2's a1 operands (bf16: rounded; the difference of two bf16
            // values of one slice pair is exact in float32 but for far
            // apart exponents)
            const float atw = BF ? ngp::bfr(at) : at;
            const float dif = BF ? ngp::bfr(ap) - ngp::bfr(am) : ap - am;
            dw2[j][0] += atw * f.x + dif * q.x;
            dw2[j][1] += atw * f.y + dif * q.y;
            dw2[j][2] += atw * f.z + dif * q.z;
            dw2[j][3] += atw * f.w + dif * q.w;
          }
          // bf16: rounded as (ii) and (iii) pack it
          *reinterpret_cast<float4*>(dz_s + cl * s.HS + 4 * hg) = make_float4(dz[0], dz[1], dz[2], dz[3]);
        }
      }
    }
    __syncthreads();  // adjoint: (i) and B1 (dz1_sum in)
    if (TIER == ngp::TIER_FASTBWD) {  // (iii) reads the encoding rounded; (i) read it exact
      ngp::round_enc_row(enc_s, s);
      __syncthreads();  // adjoint: the encoding rounded (fastbwd)
    }

    // ---- (iii) dW1c += enc^T dz1_sum; then the next row's encoding is
    // copied while (ii) computes dEnc of this one ------------------------------
    if constexpr (BF)
      ngp::dw1_rows_mma<TPT>(acc, enc_s, dz_s, s);
    else
      ngp::dw1_row<TPT>(acc, enc_s, dz_s, s);
    __syncthreads();  // adjoint: (iii); enc_s free
    if (r + 1 < r1) {
      const Row wn = tile_row(r + 1, ntx, nx, ny, zr.n);
      ngp::copy_enc_row(enc_s, s, enc, wn.z + zr.hz, plane, (size_t)wn.gy * nx + wn.gx, wn.valid);
    }
    if (denc != nullptr) {
      float* out = denc + (size_t)w.z * LF * plane;
      if (BF)
        ngp::denc_rows_mma(out, plane, w.x0, w.y0, nx, ny, sh + m.w1, dz_s, s);
      else
        ngp::denc_row(out, plane, w.x0, w.y0, nx, ny, sh + m.w1, dz_s, s);
    }
  }
  __syncthreads();  // adjoint: the last (ii), before the scratch overlays dz_s

  // ---- the block's partials -------------------------------------------------
  const size_t blk = blockIdx.x;
  float* red = sh + m.enc;
  if constexpr (BF)
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

// tpt: (iii)'s tiles a thread (f32, fastbwd: 1 or 2) or a warp (bf16:
// 1, 2, 4 or 8; ngp_head.cuh mma_tiles_per_warp).
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
  if constexpr (TIER == ngp::TIER_BF16) {
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
// host computes it); LF <= 64, H <= 256 and the adjoint pass's shared
// memory within a block's (the host gates); tier: TIER_F32, TIER_BF16 or
// TIER_FASTBWD.
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
  // the whole grid (hz = 0), or a shard's rows with two halo rows a side
  const pat::ZRows zr{z0, nz_local, nz, nz_local == nz ? 0 : 2};
  const int nb = zr.nb();
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz_local;
  const size_t smem1 = ngp::layout(sh, 0).total * sizeof(float);
  const size_t smem3 = ngp::layout(sh, 2).total * sizeof(float);
  if (LF < 1 || LF > 64 || H < 1 || H > 256 || smem3 + ngp::SMEM_STATIC > (size_t)ngp::SMEM_LIMIT || nblk < 1 ||
      nblk != (nrows < ngp::NBLK ? nrows : ngp::NBLK) || tier < ngp::TIER_F32 || tier > ngp::TIER_FASTBWD ||
      nz_local < 1 || z0 < 0 || z0 + nz_local > nz || (zr.hz == 0 && z0 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t ncell = (size_t)nb * ny * nx;
  const int nrows_f = ntx * nty * nb;  // the fields pass walks every buffer row
  cudaError_t err;

  // pass 1: TIER_FASTBWD's forward is the f32 tier's
  if (tier == ngp::TIER_BF16) {
    cudaFuncSetAttribute(k_ngp_fields<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    k_ngp_fields<true><<<nblk, NT, smem1, s>>>(enc, w1c, tb1, w2, b2, fbuf, nx, ny, nb, LF, H, ntx, nrows_f);
  } else {
    cudaFuncSetAttribute(k_ngp_fields<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    k_ngp_fields<false><<<nblk, NT, smem1, s>>>(enc, w1c, tb1, w2, b2, fbuf, nx, ny, nb, LF, H, ntx, nrows_f);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

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

#define PAT_NGP_ARGS                                                                          \
  enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part, db2_part, nx, ny, zr, LF, H, ntx, nrows, nblk, \
      periodic, k, smem3, s
  const int tpt = ngp::tiles_per_thread(sh);
  err = tier == ngp::TIER_BF16      ? launch_adjoint_tpt<ngp::TIER_BF16>(ngp::mma_tiles_per_warp(sh), PAT_NGP_ARGS)
        : tier == ngp::TIER_FASTBWD ? launch_adjoint_tpt<ngp::TIER_FASTBWD>(tpt, PAT_NGP_ARGS)
                                    : launch_adjoint_tpt<ngp::TIER_F32>(tpt, PAT_NGP_ARGS);
#undef PAT_NGP_ARGS
  if (err != cudaSuccess) return (int)err;

  ngp::k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<H * 6, NT, 0, s>>>(head_part, dhead, H * 6, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return (int)cudaGetLastError();
}
