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
// adjoint: a cell's cotangent is its own error. TIER_F32 runs on the tiled
// head core of ngp_head.cuh (TIER_BF16 below), on the same persistent grid (min(tile rows, 264)
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
// TIER_BF16 (pallas/fit.py:440-527) rounds every product's operands to
// bf16 and sums in float32: base = bf16(enc) bf16(W1c), y = bf16(a1)
// bf16(W2) + b2, da1 = bf16(W2) bf16(gy), dW2 += bf16(a1)^T bf16(gy), dW1 +=
// bf16(enc)^T bf16(dz1), dEnc = bf16(dz1) bf16(W1c)^T; the masks come from
// the float32 a1, and e, the loss partials, gy's float32 value for db2, db1
// and db2 stay float32. Its bound is the bytes (enc and dEnc in float32, the
// target: 0.051 ms). It runs on a kernel of its own, bfk::k_ngp_fit_bf16,
// K5 bf16's adjoint (ngp_mma.cuh) with the stencil replaced by the data
// error and the forward brought into the walk:
//   forward, cells on M: base from ldmatrix.trans of the row's bf16
//     encoding, + tb1, ReLU and bf16 on the packed pairs into layer 2's A
//     fragment, y in the C fragments; e = (y + b2) - target, gy = scale e,
//     db2 and the row's loss sums (warp shuffles) in registers; gy to
//     shared memory as one 16-byte bf16 row a cell, [gy | 0 0 0 0].
//   backward, hidden units on M, per 16 cells: base^T recomputed on the
//     tensor cores, da1 = [W2 | 0] . [gy | 0] (m16n8k8), B1 on the C
//     fragments (mask, dz1, db1), dW2 += bf16(a1) . gy (ldmatrix.trans of
//     the same rows), dW1^T += bf16(dz1) . enc; bf16(dz1) hidden-major for
//     dEnc, cells on M, by ldmatrix.trans.
//   One barrier a row: the interval of row r runs dEnc of row r - 1, the
//     backward of row r, the encoding copy of row r + 2 and the forward of
//     row r + 1, with the encoding in a ring of three bf16 rows (read from
//     DRAM once a cell), gy and the loss sums double-buffered, and row r + 1's
//     target and row r + 2's first 16 channels loaded into registers before
//     the interval's products. Where two dz1 rows would cost the second
//     block an SM, dEnc takes an interval of its own (two barriers a row).
// The forward's base (cells on M) and the backward's base^T (hidden units
// on M) are the same sixteen-deep dot products of the same bf16 operands on
// the tensor cores; a last-bit difference between them, should the
// hardware order the two sums otherwise, only moves a mask where base + tb1
// is within an ulp of 0 (chip_smoke.py holds the kernel to its plain
// version at 1e-4 / 1e-3 either way). The flagship LF = 16, H = 64 takes
// 104 KB of shared memory: two blocks an SM.

#include "ngp_mma.cuh"

namespace {

using ngp::NCG;
using ngp::NT;
using ngp::TM;
using ngp::TX;
using ngp::TY;

// TIER_F32. TPT: dW1c tiles a thread owns in (iii) (ngp_head.cuh).
template <int TPT>
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
  ngp::load_weights(sh, s, m, w1c, w2);
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
  // (iii)'s sums: TPT 4 x 4 tiles a thread
  float db1[4] = {0.f, 0.f, 0.f, 0.f}, dw2[4][4], acc[TPT][16], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 4; ++o) dw2[j][o] = 0.f;
#pragma unroll
  for (int t = 0; t < TPT; ++t)
#pragma unroll
    for (int v = 0; v < 16; ++v) acc[t][v] = 0.f;

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
    if (sub < s.tpg) {
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
          const float act = fmaxf(bv[j] + tb_s[h + j].x, 0.f);
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
    gy_s[tid] = g;  // the operand of da1 and dW2
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
            dw2[j][0] += at * q.x;
            dw2[j][1] += at * q.y;
            dw2[j][2] += at * q.z;
            dw2[j][3] += at * q.w;
          }
          *slot = make_float4(dz[0], dz[1], dz[2], dz[3]);
        }
      }
    }
    __syncthreads();  // B1, dz1 in
    // ---- (iii) dW1c += enc^T dz1; then the next row's encoding and target
    // are fetched while (ii) computes dEnc of this one --------------------------
    ngp::dw1_row<TPT>(acc, enc_s, dz_s, s);
    __syncthreads();  // (iii); enc_s free
    if (r + 1 < r1) fetch(r + 1);
    if (denc != nullptr) {
      float* out = denc + (size_t)z * LF * plane;
      ngp::denc_row(out, plane, x0, y0, nx, ny, sh + m.w1, dz_s, s);
    }
  }
  __syncthreads();  // the last (ii), before the scratch overlays dz_s

  // ---- the block's partials ---------------------------------------------------
  const size_t blk = blockIdx.x;
  float* red = sh + m.enc;
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

template <int TPT>
cudaError_t launch_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                       const float* b2, const float* tgt, float* denc, float* tile_parts,
                       float* dw1_part, float* head_part, float* db2_part, int nx, int ny, int nz,
                       int LF, int H, int ntx, int nrows, int nblk, float scale_sigma, float scale_u,
                       size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_fit<TPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_fit<TPT><<<nblk, NT, smem, s>>>(enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part, head_part,
                                        db2_part, nx, ny, nz, LF, H, ntx, nrows, scale_sigma, scale_u);
  return cudaGetLastError();
}

// ---- TIER_BF16 on the tensor cores (ngp_mma.cuh) ---------------------------
namespace bfk {

// Dynamic shared memory, byte offsets: W2's B fragments [nmt][32] uint2,
// tb1 [HP] float, W1c^T's A fragments [nmt][nkc][32] uint4 (also the
// forward's B: load_w1a) and B fragments [nmt][2 nkc][32] uint2,
// the rows' loss sums [2][NW][2] float (after the walk: each warp's db2),
// gy [2][NT] x 8 bf16 (the four cotangents, then four zeros: da1's
// [W2 | 0] . [gy | 0] and dW2's B by ldmatrix.trans from one row a cell),
// the encoding [3][LFP][ES] bf16 (a ring of three rows) and bf16(dz1)
// [ndz][HP][ES] (hidden-major). After the walk the cell splits' partial sums
// [S][HP][5 + LFP] float overlay gy onward.
struct FitSmem {
  int w2f, tb, w1a, w1b, loss, gy, enc, dz, total;
};

__host__ __device__ inline FitSmem fit_layout(const Dims& d, int ndz) {
  FitSmem m;
  m.w2f = 0;
  m.tb = m.w2f + d.nmt * 32 * 8;
  m.w1a = m.tb + d.HP() * 4;
  m.w1b = m.w1a + d.nmt * d.nkc * 32 * 16;
  m.loss = m.w1b + d.nmt * 2 * d.nkc * 32 * 8;
  m.gy = m.loss + 2 * (NT / 32) * 2 * 4;
  m.enc = m.gy + 2 * NT * 16;
  m.dz = m.enc + 3 * d.LFP() * ES * 2;
  const int rows = m.dz + ndz * d.HP() * ES * 2;
  const int red = m.gy + d.S * d.HP() * (5 + d.LFP()) * 4;
  m.total = rows > red ? rows : red;
  return m;
}

// dz1's buffers: two (dEnc of a row beside the next row's products, one
// barrier a row) where that keeps as many blocks an SM as one does.
__host__ inline int fit_ndz(const Dims& d) {
  const int one = fit_layout(d, 1).total, two = fit_layout(d, 2).total;
  const int cap = ngp::SMEM_LIMIT - ngp::SMEM_STATIC;
  return two <= SMEM_2BLK || (one > SMEM_2BLK && two <= cap) ? 2 : 1;
}

// K7 bf16. MPW: the hidden-unit m-tiles a warp owns in the backward (1; 2
// past H = 128); NKC: nkc_class; ndz: fit_ndz. The walk keeps three rows in
// flight: the interval of row r runs dEnc of row r - 1, the backward of row
// r, the forward of row r + 1 and the encoding copy of row r + 2, one
// barrier a row (two where one dz1 buffer is all that fits).
template <int MPW, int NKC>
__global__ void __launch_bounds__(NT, 2)
    k_ngp_fit_bf16(const float* __restrict__ enc, const float* __restrict__ w1c, const float* __restrict__ tb1,
                   const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ tgt,
                   float* __restrict__ denc, float* __restrict__ tile_parts, float* __restrict__ dw1_part,
                   float* __restrict__ head_part, float* __restrict__ db2_part, int nx, int ny, int nz, int LF,
                   int H, int ntx, int nrows, float scale_sigma, float scale_u, int ndz) {
  extern __shared__ float4 sh4[];
  char* sh = reinterpret_cast<char*>(sh4);
  const Dims d = make_dims(LF, H);
  const FitSmem m = fit_layout(d, ndz);
  uint2* w2f = reinterpret_cast<uint2*>(sh + m.w2f);
  float* tb_s = reinterpret_cast<float*>(sh + m.tb);
  uint4* w1a = reinterpret_cast<uint4*>(sh + m.w1a);
  uint2* w1b = reinterpret_cast<uint2*>(sh + m.w1b);
  float* loss_s = reinterpret_cast<float*>(sh + m.loss);  // [2][NW][2]
  uint4* gy = reinterpret_cast<uint4*>(sh + m.gy);
  uint16_t* encb = reinterpret_cast<uint16_t*>(sh + m.enc);
  uint16_t* dzb = reinterpret_cast<uint16_t*>(sh + m.dz);
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int jm = lane >> 3, jr = lane & 7;  // ldmatrix: the matrix and row of this lane's address
  const int est = d.LFP() * ES, dst = d.HP() * ES;
  const size_t plane = (size_t)nx * ny;
  const int ntiles = ntx * ((ny + TY - 1) / TY);
  load_w2f(w2f, w2, d);
  load_w1a(w1a, w1c, d);
  load_w1b(w1b, w1c, d);
  for (int h = tid; h < d.HP(); h += NT) tb_s[h] = h < H ? __ldg(tb1 + h) : 0.f;
  const Owned<MPW> ow = owned<MPW>(d, warp);
  // Per m-tile, in registers: da1's A fragment [W2 | 0] of hidden units
  // 16 mt + g (a0) and + 8 (a1), and their tb1.
  uint32_t wpt[MPW][2];
  float tbm[MPW][2];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const int h = 16 * ow.mts[i] + g + 8 * hs;
      const bool on = t < 2 && h < H;
      wpt[i][hs] = on ? pack2(__ldg(w2 + 4 * h + 2 * t), __ldg(w2 + 4 * h + 2 * t + 1)) : 0u;
      tbm[i][hs] = h < H ? __ldg(tb1 + h) : 0.f;
    }
  // The forward's outputs of this lane (t < 2): 2t, 2t + 1, their b2 and
  // gradient scales.
  const float bo[2] = {t < 2 ? __ldg(b2 + 2 * t) : 0.f, t < 2 ? __ldg(b2 + 2 * t + 1) : 0.f};
  const float sc[2] = {t == 0 ? scale_sigma : scale_u, scale_u};
  // Register sums over every row: db1 of hidden units 16 mt + g (+ 8) over
  // this thread's cells; dW2's C fragment (outputs 0..3; 4..7 meet the zero
  // half of gy); dW1^T's C fragments (n: 8 channels each); db2 of outputs
  // 2t, 2t + 1.
  float db1[MPW][2], e1[MPW][2], w2acc[MPW][4], w1acc[MPW][2 * NKC][4], db[2] = {0.f, 0.f};
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

  // The target of row r in the forward's C-fragment order: tg[mi][half][j]
  // is output 2t + j of cell 16 (warp + 8 mi) + g + 8 half (lanes t < 2;
  // zero off the grid).
  auto target_of = [&](int r, float (&tg)[2][2][2]) {
    const ngp::Row w = ngp::tile_row(r, ntx, nx, ny, nz);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = 16 * (warp + 8 * mi) + g + 8 * half, cx = w.x0 + cl % TX, cy = w.y0 + cl / TX;
        const bool on = t < 2 && cx < nx && cy < ny;
        const float* p = tgt + ((size_t)w.z * 4 + 2 * t) * plane + (size_t)cy * nx + cx;
#pragma unroll
        for (int j = 0; j < 2; ++j) tg[mi][half][j] = on ? __ldg(p + j * plane) : 0.f;
      }
  };
  auto head_of = [&](int r, float (&v)[16]) {
    const ngp::Row w = ngp::tile_row(r, ntx, nx, ny, nz);
    enc_head(v, d, enc, w.z, plane, (size_t)w.gy * nx + w.gx, w.valid);
  };
  auto store_of = [&](int r, int eb, const float (&v)[16]) {
    const ngp::Row w = ngp::tile_row(r, ntx, nx, ny, nz);
    enc_store(encb + eb * est, v, d, enc, w.z, plane, (size_t)w.gy * nx + w.gx, w.valid);
  };

  // The forward of row r (encoding buffer eb, target tg): cells on M, a
  // warp's cells 16 (warp + 8 mi) .. + 15; y = bf16(relu(base + tb1))
  // bf16(W2) in the C fragments, then e = (y + b2) - target, gy = scale e
  // (bf16, to gy buffer gb) and the row's loss sums of the warp (loss buffer
  // lb), e0^2 and (e1^2 + e2^2) + e3^2 a cell as the f32 kernel adds them.
  auto forward = [&](int r, int eb, int gb, int lb, const float (&tg)[2][2][2]) {
    const ngp::Row w = ngp::tile_row(r, ntx, nx, ny, nz);
    uint32_t ea[2][NKC][4];
    fwd_enc_frags<NKC>(ea, encb + eb * est, d, warp, jm, jr);
    float y[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int v = 0; v < 4; ++v) y[mi][v] = 0.f;
    for (int kh = 0; kh < d.nmt; ++kh) {
      const int h0 = 16 * kh + 2 * t;  // this thread's hidden units h0, h0 + 1, h0 + 8, h0 + 9
      const float u0 = tb_s[h0], u1 = tb_s[h0 + 1], u8 = tb_s[h0 + 8], u9 = tb_s[h0 + 9];
      const uint2 wb = w2f[kh * 32 + lane];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float c0[4], c1[4];  // hidden units h0.., h0 + 8..
        fwd_base<NKC>(c0, c1, ea[mi], w1a, d, kh, lane);
        mma16816(y[mi], relu2(c0[0] + u0, c0[1] + u1), relu2(c0[2] + u0, c0[3] + u1),
                 relu2(c1[0] + u8, c1[1] + u9), relu2(c1[2] + u8, c1[3] + u9), wb.x, wb.y);
      }
    }
    uint4* gyb = gy + gb * NT;
    float la = 0.f, lb_ = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = 16 * (warp + 8 * mi) + g + 8 * half, cx = w.x0 + cl % TX, cy = w.y0 + cl / TX;
        const bool on = t < 2 && cx < nx && cy < ny;
        float e[2], q[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          e[j] = on ? (y[mi][2 * half + j] + bo[j]) - tg[mi][half][j] : 0.f;
          q[j] = sc[j] * e[j];
          db[j] += q[j];
        }
        reinterpret_cast<uint32_t*>(gyb + cl)[t] = t < 2 ? pack2(q[0], q[1]) : 0u;
        // e2, e3 from the lane t = 1 of the cell to the lane t = 0
        const float e2 = __shfl_down_sync(0xffffffffu, e[0], 1), e3 = __shfl_down_sync(0xffffffffu, e[1], 1);
        if (t == 0) {
          la += e[0] * e[0];
          lb_ += (e[1] * e[1] + e2 * e2) + e3 * e3;
        }
      }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb_ += __shfl_xor_sync(0xffffffffu, lb_, off);
    }
    if (lane == 0) {
      loss_s[(lb * NW + warp) * 2] = la;
      loss_s[(lb * NW + warp) * 2 + 1] = lb_;
    }
  };

  // The backward of row r (encoding buffer eb, gy buffer gb; dz1 to dzd):
  // hidden units on M, per 16 cells base^T, da1^T = [W2 | 0] . [gy | 0], B1
  // on the C fragments (a1 = relu(base + tb1) in float32, dz1 = [a1 > 0]
  // da1, db1), dW2 += bf16(a1) . bf16(gy), dW1^T += bf16(dz1) . enc, and
  // bf16(dz1) hidden-major for dEnc.
  auto backward = [&](int eb, int gb, uint16_t* dzd) {
    const uint16_t* e_s = encb + eb * est;
    const uint4* gyb = gy + gb * NT;
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (!ow.own[i]) continue;
      const int mt = ow.mts[i];
      for (int q = ow.q0; q < ow.q1; ++q) {
        const int cq = 16 * q;
        float cb[2][4];
        base_t<NKC>(cb, w1a, e_s, d, mt, cq, lane, jm, jr);
        // gy of the 16 cells: as da1's B (k outputs, n cells) and, .trans,
        // as dW2's (k cells, n outputs)
        uint32_t gbf[2], gk[2];
        ldsm2(gbf, gyb + cq + (lane & 15));
        ldsm2_t(gk, gyb + cq + (lane & 15));
        float pt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int n = 0; n < 2; ++n) mma1688(pt[n], wpt[i][0], wpt[i][1], gbf[n]);
        // B1: v = 2 hs + j is hidden unit 16 mt + g + 8 hs at cell cq + 8 n + 2 t + j
        float dz[2][4], at[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int hs = v >> 1;
            at[n][v] = fmaxf(cb[n][v] + tbm[i][hs], 0.f);
            dz[n][v] = at[n][v] > 0.f ? pt[n][v] : 0.f;
            db1[i][hs] += dz[n][v];
          }
        uint32_t aat[4], adz[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int n = kk >> 1, v = 2 * (kk & 1);
          aat[kk] = pack2(at[n][v], at[n][v + 1]);
          adz[kk] = pack2(dz[n][v], dz[n][v + 1]);
        }
        mma16816(w2acc[i], aat[0], aat[1], aat[2], aat[3], gk[0], gk[1]);
        dw1_step<NKC>(w1acc[i], adz, e_s, d, cq, jm, jr);
        if (dzd != nullptr) store_dz(dzd, adz, mt, cq, g, t);
      }
    }
  };

  auto denc_of = [&](int r, const uint16_t* dzs) {
    denc_row<NKC>(denc, ngp::tile_row(r, ntx, nx, ny, nz), dzs, w1b, d, plane, nx, ny);
  };

  int r0, r1;
  ngp::block_rows(nrows, r0, r1);
  const bool want = denc != nullptr;
  {
    float v[16];
    if (r0 < r1) {
      head_of(r0, v);
      store_of(r0, 0, v);
    }
    if (r0 + 1 < r1) {
      head_of(r0 + 1, v);
      store_of(r0 + 1, 1, v);
    }
  }
  __syncthreads();  // fit bf16: fragments, tb1 and the first two rows' encoding in
  if (r0 < r1) {
    float tg[2][2][2];
    target_of(r0, tg);
    forward(r0, 0, 0, 0, tg);
  }
  __syncthreads();  // fit bf16: the first row's forward
  for (int r = r0; r < r1; ++r) {
    const int i = r - r0, ib = i & 1;
    // the next row's target and the encoding of the row after it: their
    // loads issued before this interval's products
    float tg[2][2][2], nxt[16];
    if (r + 1 < r1) target_of(r + 1, tg);
    if (r + 2 < r1) head_of(r + 2, nxt);
    if (ndz == 2 && want && r > r0) denc_of(r - 1, dzb + (ib ^ 1) * dst);
    backward(i % 3, ib, want ? dzb + (ndz == 2 ? ib : 0) * dst : nullptr);
    if (r + 2 < r1) store_of(r + 2, (i + 2) % 3, nxt);
    if (r + 1 < r1) forward(r + 1, (i + 1) % 3, ib ^ 1, ib ^ 1, tg);
    if (tid == 0) {  // the row's loss tile partials: tile = ty * ntx + tx, the host's tile order
      float la = 0.f, lb_ = 0.f;
      for (int k = 0; k < NW; ++k) {
        la += loss_s[(ib * NW + k) * 2];
        lb_ += loss_s[(ib * NW + k) * 2 + 1];
      }
      const int z = r % nz, tile = r / nz;
      tile_parts[(size_t)z * ntiles + tile] = la;
      tile_parts[((size_t)nz + z) * ntiles + tile] = lb_;
    }
    __syncthreads();  // fit bf16: the row's backward, the next row's forward, dEnc of the row before
    if (ndz == 1 && want) {
      denc_of(r, dzb);
      __syncthreads();  // fit bf16: dEnc of the row (one dz1 buffer)
    }
  }
  if (ndz == 2 && want && r1 > r0) denc_of(r1 - 1, dzb + ((r1 - 1 - r0) & 1) * dst);
  // db2 of the warp: lanes t < 2 hold outputs 2t, 2t + 1 of their cells
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    db[0] += __shfl_xor_sync(0xffffffffu, db[0], off);
    db[1] += __shfl_xor_sync(0xffffffffu, db[1], off);
  }
  if (lane < 2) {
    loss_s[warp * 4 + 2 * lane] = db[0];
    loss_s[warp * 4 + 2 * lane + 1] = db[1];
  }
  __syncthreads();  // fit bf16: the last dEnc, before the scratch overlays the rows; db2 of the warps in
  head_partials<MPW, NKC, false>(reinterpret_cast<float*>(sh + m.gy), ow, db1, e1, 0.f, w2acc, w1acc, d, dw1_part,
                                 head_part);
  if (tid < 4) {
    float sum = 0.f;
    for (int k = 0; k < NW; ++k) sum += loss_s[k * 4 + tid];
    db2_part[(size_t)blockIdx.x * 4 + tid] = sum;
  }
}

template <int MPW, int NKC>
cudaError_t launch_fit(const float* enc, const float* w1c, const float* tb1, const float* w2, const float* b2,
                       const float* tgt, float* denc, float* tile_parts, float* dw1_part, float* head_part,
                       float* db2_part, int nx, int ny, int nz, int LF, int H, int ntx, int nrows, int nblk,
                       float scale_sigma, float scale_u, int ndz, size_t smem, cudaStream_t s) {
  cudaFuncSetAttribute(k_ngp_fit_bf16<MPW, NKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_fit_bf16<MPW, NKC><<<nblk, NT, smem, s>>>(enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part,
                                                   head_part, db2_part, nx, ny, nz, LF, H, ntx, nrows, scale_sigma,
                                                   scale_u, ndz);
  return cudaGetLastError();
}

}  // namespace bfk

}  // namespace

// enc [nz, LF, ny, nx], W1c [LF, H] (the leading rows of W1), tb1 [H],
// W2 [H, 4], b2 [4], target [nz, 4, ny*nx]; scratch: tile partials
// [2, nz, ntiles], dW1c partials [nblk, LF, H], (db1, dW2) partials
// [nblk, H, 5], db2 partials [nblk, 4]; outputs dEnc (or null), dW1c
// [LF, H], dhead [H, 5] = (db1, dW2) side by side, db2 [4]. nblk =
// min(tile rows, NBLK) (the host computes it); LF <= 64, H <= 256 and the
// head core's shared memory within a block's (the host gates; TIER_BF16's
// own layout fits wherever that one does); tier: TIER_F32 or TIER_BF16.
extern "C" int pat_ngp_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                           const float* b2, const float* tgt, float* tile_parts, float* dw1_part,
                           float* head_part, float* db2_part, float* denc, float* dw1c,
                           float* dhead, float* db2, int nx, int ny, int nz, int LF, int H,
                           int nblk, float scale_sigma, float scale_u, int tier, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ngp::Shape sh = ngp::make_shape(LF, H);
  const bfk::Dims bd = bfk::make_dims(LF, H);
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz;
  const bool bf = tier == ngp::TIER_BF16;
  const int ndz = bf ? bfk::fit_ndz(bd) : 0;
  const size_t smem = bf ? bfk::fit_layout(bd, ndz).total : ngp::layout(sh, 1).total * sizeof(float);
  const size_t cap = ngp::SMEM_LIMIT - ngp::SMEM_STATIC;
  if (LF < 1 || LF > 64 || H < 1 || H > 256 || ngp::layout(sh, 1).total * sizeof(float) > cap || smem > cap ||
      nblk < 1 || nblk != (nrows < ngp::NBLK ? nrows : ngp::NBLK) || (tier != ngp::TIER_F32 && !bf))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (bf) {
    const int nkc = bfk::nkc_class(bd);
#define PAT_NGP_FIT_ARGS                                                                                        \
  enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part, head_part, db2_part, nx, ny, nz, LF, H, ntx, nrows, nblk, \
      scale_sigma, scale_u, ndz, smem, s
    if (bd.nmt > 8)
      err = nkc == 1 ? bfk::launch_fit<2, 1>(PAT_NGP_FIT_ARGS)
            : nkc == 2 ? bfk::launch_fit<2, 2>(PAT_NGP_FIT_ARGS)
                       : bfk::launch_fit<2, 4>(PAT_NGP_FIT_ARGS);
    else
      err = nkc == 1 ? bfk::launch_fit<1, 1>(PAT_NGP_FIT_ARGS)
            : nkc == 2 ? bfk::launch_fit<1, 2>(PAT_NGP_FIT_ARGS)
                       : bfk::launch_fit<1, 4>(PAT_NGP_FIT_ARGS);
#undef PAT_NGP_FIT_ARGS
  } else {
#define PAT_NGP_FIT_ARGS                                                                        \
  enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part, head_part, db2_part, nx, ny, nz, LF, H, \
      ntx, nrows, nblk, scale_sigma, scale_u, smem, s
    // (iii)'s tiles a thread: 1 or 2
    const int tpt = ngp::tiles_per_thread(sh);
    if (tpt == 1) err = launch_fit<1>(PAT_NGP_FIT_ARGS);
    if (tpt == 2) err = launch_fit<2>(PAT_NGP_FIT_ARGS);
#undef PAT_NGP_FIT_ARGS
  }
  if (err != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<H * 5, NT, 0, s>>>(head_part, dhead, H * 5, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ngp::k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return (int)cudaGetLastError();
}
