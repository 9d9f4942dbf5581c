// K7: the supervised-fit kernel of the encoded field (the data loss and
// every head / encoding gradient in one call), sm_90a.
//
// Replaces _build_ngp_fit_call of phys_autodiff_tpu/pallas/fit.py (:385).
// Inputs: the encoding enc [nz, LF, ny, nx], W1c = W1[:-1] [LF, H], the
// first layer's bias at the one slice tb1 = b1 + W1[-1] t [H], W2 [H, 4],
// b2 [4] and the packed target [nz, 4, ny * nx]. Per cell
//   base = W1c^T enc,  a1 = relu(base + tb1),  y = W2^T a1 + b2,
//   e = y - target,  gy = (2w/N) e,  dz1 = [a1 > 0] W2 gy,
// and the outputs, as the JAX kernel's: the per-(z plane, tile) loss
// partials, dEnc = W1c dz1 [nz, LF, ny, nx] (skipped for a parameter-free
// encoding: denc == nullptr), dW1c = sum enc dz1^T [LF, H], db1 = sum dz1
// [H], dW2 = sum a1 gy^T [H, 4] and db2 = sum gy [4]. The host takes W1's
// last row as t db1 and d_t = W1[-1] . db1, and pulls dEnc back to the
// encoder's parameters by autograd.
//
// K7 is K5 (mega_ngp.cu) without its first two passes and the stencil
// adjoint: a cell's cotangent is its own error. It runs on the tiled head
// core of ngp_head.cuh, on the same persistent grid (min(tile rows, 264)
// blocks, one whole wave at two blocks an SM; 98 KB of shared memory at
// LF = 16, H = 64). Launches, no float atomics:
//   1. k_ngp_fit, per tile row:
//      A   thread per cell: the row's encoding to shared memory (cp.async)
//          and its target to registers, issued during the row before.
//      (i) base of the row (4 cells x 4 hidden units a thread) to shared
//          memory, where it stays for B1: K7 computes it once.
//      fwd thread per cell: y = W2^T relu(base + tb1) + b2 over the hidden
//          units in order, e, gy (to shared memory) and the row's loss
//          tile partials (block sums).
//      B1  per head item: dz1 = [a1 > 0] W2 gy written over its base; db1
//          and dW2 accumulate in registers over every row.
//      (iii) dW1c += enc^T dz1 in registers; then the next row's fetch
//          is issued and (ii) computes dEnc of this row while it flies.
//      Each block writes its partials.
//   2. k_sum_parts (ngp_head.cuh): dW1c, (db1, dW2) and db2 added in a fixed
//      order.
//
// Bound on this card: FP32 operations (FFMA on the CUDA cores; no tensor
// cores). The function needs 6 LF H + 28 H + 23 operations a cell, an FMA
// counted as two: forward base 2 LF H, the bias, the ReLU and y 10 H;
// backward W2 . gy 8 H, the mask H, db1 H, dW2 8 H, dW1c and dEnc 2 LF H
// each; e, the squares, gy and db2 23. At LF = 16, H = 64 on 128x96x96
// that is 9.39 GFLOP, 0.140 ms at 67 TFLOP/s. The compulsory bytes are enc
// and dEnc (75.5 MB each) and the target (18.9 MB), 0.051 ms at 3.35 TB/s.
// What the design does about the bound: every product feeds 8 to 16 FMAs
// from one shared load, base is computed once (the first version computed
// it twice, 2 LF H a cell more), and the grid is one whole wave.
//
// TIER_BF16 (BF; pallas/fit.py:440-527): base = bf16(enc) bf16(W1c), dW1 +=
// bf16(enc)^T bf16(dz1) and dEnc = bf16(dz1) bf16(W1c)^T on the tensor
// cores (ngp_head.cuh's mma.sync products), y = bf16(a1) bf16(W2) + b2,
// da1 = bf16(W2) bf16(gy) and dW2 += bf16(gy)^T bf16(a1) on the CUDA cores
// with W2 and gy rounded as they enter shared memory and a1 where it is
// formed; the mask comes from the float32 a1, and e, the partials, db2 and
// db1 stay float32.

#include "ngp_head.cuh"

namespace {

using ngp::NCG;
using ngp::NT;
using ngp::TM;
using ngp::TX;
using ngp::TY;

// TPT: dW1c tiles a thread owns in (iii) (ngp_head.cuh); BF: TIER_BF16.
template <int TPT, bool BF>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_fit(const float* __restrict__ enc, const float* __restrict__ w1c,
              const float* __restrict__ tb1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ tgt,
              float* __restrict__ denc, float* __restrict__ tile_parts,
              float* __restrict__ dw1_part, float* __restrict__ head_part,
              float* __restrict__ db2_part, int nx, int ny, int nz, int LF, int H, int ntx,
              int nrows, float scale_sigma, float scale_u) {
  extern __shared__ float4 sh4[];
  __shared__ float red2[2 * NT / 32];
  float* sh = reinterpret_cast<float*>(sh4);
  const ngp::Shape s = ngp::make_shape(LF, H);
  const ngp::Smem m = ngp::layout(s, 1);
  ngp::load_weights(sh, s, m, w1c, w2, BF);
  ngp::load_biases(sh, s, m, tb1, 1);
  const float4* w2_s = reinterpret_cast<const float4*>(sh + m.w2);
  const float4* tb_s = reinterpret_cast<const float4*>(sh + m.tb);
  float4* gy_s = reinterpret_cast<float4*>(sh + m.gy);  // [NT]
  float* enc_s = sh + m.enc;
  float* dz_s = sh + m.dz;  // base, then dz1 in place
  const int tid = threadIdx.x, hg = tid % s.nhg, sub = tid / s.nhg;
  const size_t plane = (size_t)nx * ny;
  const int ntiles = ntx * ((ny + TY - 1) / TY);
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  // (iii)'s sums: TPT 4 x 4 tiles a thread (f32) or TPT m16 x n8 tiles a
  // warp, a quarter of each a thread (bf16)
  constexpr int NACC = BF ? 4 : 16;
  float db1[4] = {0.f, 0.f, 0.f, 0.f}, dw2[4][4], acc[TPT][NACC], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 4; ++o) dw2[j][o] = 0.f;
#pragma unroll
  for (int t = 0; t < TPT; ++t)
#pragma unroll
    for (int v = 0; v < NACC; ++v) acc[t][v] = 0.f;

  // Row r's tile origin, this thread's cell and whether it lies on the grid.
  auto row_cell = [&](int r, int& z, int& x0, int& y0, size_t& cell) {
    const int tile = r / nz;
    z = r % nz;
    x0 = (tile % ntx) * TX;
    y0 = (tile / ntx) * TY;
    const int gx = x0 + tid % TX, gy = y0 + tid / TX;
    cell = (size_t)gy * nx + gx;
    return gx < nx && gy < ny;
  };
  // The encoding (shared memory, cp.async) and the target (registers) of
  // row r, issued one row ahead so that they arrive while (ii) runs.
  float tv[4] = {0.f, 0.f, 0.f, 0.f};
  auto fetch = [&](int r) {
    int z, x0, y0;
    size_t cell;
    const bool valid = row_cell(r, z, x0, y0, cell);
    ngp::copy_enc_row(enc_s, s, enc, z, plane, cell, valid);
#pragma unroll
    for (int o = 0; o < 4; ++o) tv[o] = valid ? __ldg(tgt + ((size_t)z * 4 + o) * plane + cell) : 0.f;
  };
  ngp::zero_enc_rows(enc_s, s);
  __syncthreads();  // weights in, encoding rows zeroed
  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  if (r0 < r1) fetch(r0);
  for (int r = r0; r < r1; ++r) {
    int z, x0, y0;
    size_t cell;
    const bool valid = row_cell(r, z, x0, y0, cell);
    const int tile = r / nz;
    // ---- A: the row's encoding in -------------------------------------------
    ngp::wait_enc_row();
    __syncthreads();  // (ii) of the last row; the encoding of this one in
    // ---- (i): base to shared memory, kept there for B1 -----------------------
    if (BF) {
      ngp::base_rows_mma(dz_s, enc_s, sh + m.w1, s);
    } else if (sub < s.tpg) {
      for (int cg = sub; cg < NCG; cg += s.tpg) {
        float b[TM][4];
        ngp::base_item(b, sh + m.w1, enc_s, s, cg, hg);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          *reinterpret_cast<float4*>(dz_s + (cg + i * NCG) * s.HS + 4 * hg) =
              make_float4(b[i][0], b[i][1], b[i][2], b[i][3]);
      }
    }
    __syncthreads();  // (i), base in
    // ---- the forward, thread per cell: y, e, gy and the loss partials ---------
    float a = 0.f, bb = 0.f;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      const float* brow = dz_s + tid * s.HS;
      for (int h = 0; h < s.HP; h += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(brow + h);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = fmaxf(bv[j] + tb_s[h + j].x, 0.f), act = BF ? ngp::bfr(a) : a;
          const float4 wo = w2_s[h + j];
          y[0] = fmaf(act, wo.x, y[0]);
          y[1] = fmaf(act, wo.y, y[1]);
          y[2] = fmaf(act, wo.z, y[2]);
          y[3] = fmaf(act, wo.w, y[3]);
        }
      }
      const float e0 = (y[0] + b2r[0]) - tv[0];
      const float e1 = (y[1] + b2r[1]) - tv[1];
      const float e2 = (y[2] + b2r[2]) - tv[2];
      const float e3 = (y[3] + b2r[3]) - tv[3];
      a = e0 * e0;
      bb = (e1 * e1 + e2 * e2) + e3 * e3;
      g = make_float4(scale_sigma * e0, scale_u * e1, scale_u * e2, scale_u * e3);
      db[0] += g.x;
      db[1] += g.y;
      db[2] += g.z;
      db[3] += g.w;
    }
    gy_s[tid] = BF ? ngp::bfr4(g) : g;  // the operand of da1 and dW2
    pat::block_sum2<NT>(a, bb, red2);
    if (tid == 0) {  // tile = ty * ntx + tx, the host's tile order
      tile_parts[(size_t)z * ntiles + tile] = a;
      tile_parts[((size_t)nz + z) * ntiles + tile] = bb;
    }
    __syncthreads();  // the forward: gy_s complete; red2 free again
    // ---- B1 on the base items: dz1 = [a1 > 0] W2 gy, written over base --------
    if (sub < s.tpg) {
      float tbr[4];  // the thread's hidden units, loaded once a row
      float4 w2r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tbr[j] = tb_s[4 * hg + j].x;
        w2r[j] = w2_s[4 * hg + j];
      }
      for (int cg = sub; cg < NCG; cg += s.tpg) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int cl = cg + i * NCG;
          float4* slot = reinterpret_cast<float4*>(dz_s + cl * s.HS + 4 * hg);
          const float4 b4 = *slot, q = gy_s[cl];  // q is zero off the grid
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          float dz[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wr = w2r[j];
            const float at = fmaxf(bv[j] + tbr[j], 0.f);
            const float p = wr.x * q.x + wr.y * q.y + wr.z * q.z + wr.w * q.w;
            dz[j] = at > 0.f ? p : 0.f;
            db1[j] += dz[j];
            const float atw = BF ? ngp::bfr(at) : at;
            dw2[j][0] += atw * q.x;
            dw2[j][1] += atw * q.y;
            dw2[j][2] += atw * q.z;
            dw2[j][3] += atw * q.w;
          }
          *slot = make_float4(dz[0], dz[1], dz[2], dz[3]);  // bf16: rounded as (ii) and (iii) pack it
        }
      }
    }
    __syncthreads();  // B1, dz1 in
    // ---- (iii) dW1c += enc^T dz1; then the next row's encoding and target
    // are fetched while (ii) computes dEnc of this one --------------------------
    if constexpr (BF)
      ngp::dw1_rows_mma<TPT>(acc, enc_s, dz_s, s);
    else
      ngp::dw1_row<TPT>(acc, enc_s, dz_s, s);
    __syncthreads();  // (iii); enc_s free
    if (r + 1 < r1) fetch(r + 1);
    if (denc != nullptr) {
      float* out = denc + (size_t)z * LF * plane;
      if (BF)
        ngp::denc_rows_mma(out, plane, x0, y0, nx, ny, sh + m.w1, dz_s, s);
      else
        ngp::denc_row(out, plane, x0, y0, nx, ny, sh + m.w1, dz_s, s);
    }
  }
  __syncthreads();  // the last (ii), before the scratch overlays dz_s

  // ---- the block's partials ---------------------------------------------------
  const size_t blk = blockIdx.x;
  float* red = sh + m.enc;
  if constexpr (BF)
    ngp::dw1_store_mma<TPT>(dw1_part + blk * LF * H, acc, s);
  else
    ngp::dw1_store<TPT>(dw1_part + blk * LF * H, acc, red, s);
  float vals[4][5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    vals[j][0] = db1[j];
#pragma unroll
    for (int o = 0; o < 4; ++o) vals[j][1 + o] = dw2[j][o];
  }
  ngp::head_store<5>(head_part + blk * H * 5, vals, red, s);
  pat::block_sum2<NT>(db[0], db[1], red2);
  __syncthreads();  // red2 free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red2);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[blk * 4 + c] = db[c];
  }
}

template <int TPT, bool BF>
cudaError_t launch_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                       const float* b2, const float* tgt, float* denc, float* tile_parts,
                       float* dw1_part, float* head_part, float* db2_part, int nx, int ny, int nz,
                       int LF, int H, int ntx, int nrows, int nblk, float scale_sigma, float scale_u,
                       size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_fit<TPT, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_fit<TPT, BF><<<nblk, NT, smem, s>>>(enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part,
                                        head_part, db2_part, nx, ny, nz, LF, H, ntx, nrows,
                                        scale_sigma, scale_u);
  return cudaGetLastError();
}

}  // namespace

// enc [nz, LF, ny, nx], W1c [LF, H] (the leading rows of W1), tb1 [H],
// W2 [H, 4], b2 [4], target [nz, 4, ny*nx]; scratch: tile partials
// [2, nz, ntiles], dW1c partials [nblk, LF, H], (db1, dW2) partials
// [nblk, H, 5], db2 partials [nblk, 4]; outputs dEnc (or null), dW1c
// [LF, H], dhead [H, 5] = (db1, dW2) side by side, db2 [4]. nblk =
// min(tile rows, NBLK) (the host computes it); LF <= 64, H <= 256 and the
// shared memory within a block's (the host gates); tier: TIER_F32 or
// TIER_BF16.
extern "C" int pat_ngp_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                           const float* b2, const float* tgt, float* tile_parts, float* dw1_part,
                           float* head_part, float* db2_part, float* denc, float* dw1c,
                           float* dhead, float* db2, int nx, int ny, int nz, int LF, int H,
                           int nblk, float scale_sigma, float scale_u, int tier, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ngp::Shape sh = ngp::make_shape(LF, H);
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz;
  const size_t smem = ngp::layout(sh, 1).total * sizeof(float);
  if (LF < 1 || LF > 64 || H < 1 || H > 256 || smem + ngp::SMEM_STATIC > (size_t)ngp::SMEM_LIMIT || nblk < 1 ||
      nblk != (nrows < ngp::NBLK ? nrows : ngp::NBLK) || (tier != ngp::TIER_F32 && tier != ngp::TIER_BF16))
    return (int)cudaErrorInvalidValue;
#define PAT_NGP_FIT_ARGS                                                                        \
  enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part, head_part, db2_part, nx, ny, nz, LF, H, \
      ntx, nrows, nblk, scale_sigma, scale_u, smem, s
  // (iii)'s tiles a thread (f32: 1 or 2) or a warp (bf16: 1, 2, 4 or 8)
  cudaError_t err = cudaErrorInvalidValue;
  if (tier == ngp::TIER_BF16) {
    const int tpw = ngp::mma_tiles_per_warp(sh);
    if (tpw == 1) err = launch_fit<1, true>(PAT_NGP_FIT_ARGS);
    if (tpw == 2) err = launch_fit<2, true>(PAT_NGP_FIT_ARGS);
    if (tpw == 4) err = launch_fit<4, true>(PAT_NGP_FIT_ARGS);
    if (tpw == 8) err = launch_fit<8, true>(PAT_NGP_FIT_ARGS);
  } else {
    const int tpt = ngp::tiles_per_thread(sh);
    if (tpt == 1) err = launch_fit<1, false>(PAT_NGP_FIT_ARGS);
    if (tpt == 2) err = launch_fit<2, false>(PAT_NGP_FIT_ARGS);
  }
#undef PAT_NGP_FIT_ARGS
  if (err != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<H * 5, NT, 0, s>>>(head_part, dhead, H * 5, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return (int)cudaGetLastError();
}
