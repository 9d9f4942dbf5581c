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
// gradients are the same bits from run to run.
//   1. k_ngp_fields: one thread per cell evaluates the head for the three
//      slices and writes the fields to fbuf [12, nz, ny, nx] (t slice
//      first, so fbuf[0:4] is the [4, nz, ny, nx] the adjoint reads).
//      Measured on one H100 for K4, writing the t slice beat recomputing the
//      halo; here the head is cheaper to store than to recompute at six
//      neighbours.
//   2. k_residuals<MODE_SCALED_PARTIALS> (residuals.cuh, K1's body): the
//      loss tile partials and g = (2w/N) R [4, nz, ny, nx].
//   3. k_ngp_adjoint: a block owns a 32 x 8 (x, y) tile and ZC z rows and
//      walks them one row at a time:
//      A  thread per cell: the stencil adjoint (adjoint.cuh) gives the
//         cotangents gy of the 12 fields (t slice: dF; t -+ dt: -+ g/2dt);
//         dF, g/2dt and the cell's encoding go to shared memory.
//      B1 thread (h, cell subset), h-major as K4's phase B: recompute
//         base[h] from the encoding (the [N, H] activations, 300 MB at the
//         flagship, are never stored), then dz1_s = [a1_s > 0] W2[h] . gy_s;
//         db1[h], dtw1[h] and dW2[h, :] accumulate in registers over every
//         cell the thread visits; dz1_sum[h, cell] goes to shared memory.
//         The t -+ dt legs are 1/(2 dt) times larger than the t slice's and
//         nearly cancel, so, as in K4, they are added to each other per
//         cell first and never summed over the grid apart:
//         dz1_sum = dz1_t + (dz1_tm1 + dz1_tp1); dtw1 takes
//         t dz1_sum + (dt_p dz1_tp1 - dt_m dz1_tm1) (dt_m = t - t_0,
//         dt_p = t_2 - t); dW2 takes a1_t dF + (a1_tp1 - a1_tm1) g/2dt. (A
//         float32 sum of each slice's a1 gy over the grid loses about 1e-4
//         of dW2 to that cancellation, and a sum of each slice's dz1 as
//         much of db1.)
//      B2 thread per cell: dEnc[c] = sum_h W1c[c, h] dz1_sum[h, cell].
//      B3 thread per (c, h): dW1c[c, h] += sum_cell enc[c, cell]
//         dz1_sum[h, cell], accumulated in shared memory over the rows.
//         (B2, B3 and k_sum_parts are in ngp_head.cuh, shared with K7.)
//      Each block writes its partials.
//   4. k_sum_parts: the partials of dW1c, (db1, dtw1, dW2) and db2, added in a
//      fixed order.
//
// Bound on this card: FP32 operations. The compulsory DRAM traffic is the
// encoding read and dEnc write, 2 LF x 4 B a cell (151 MB at LF = 16 on
// 128x96x96, 0.045 ms at 3.35 TB/s). The head needs 6 LF H + 71 H
// operations a cell, an FMA counted as two: the base 2 LF H and 10 H a
// slice forward; backward W2 . gy for the t slice and t+dt (t-dt's is its
// negative) 16 H, the masks, the three slice sums and dz1_sum 8 H, dW2 17 H;
// dW1c and dEnc 2 LF H each. With the residual and its adjoint that is
// 13.0 GFLOP there, 0.194 ms at 67 TFLOP/s (chip_smoke.py's work table).
// This first version runs FFMA on CUDA cores and feeds phases B1-B3 from
// shared memory (about two shared loads an FMA in B2 and B3); wgmma is later
// work.

#include "adjoint.cuh"
#include "ngp_head.cuh"
#include "residuals.cuh"

namespace {

constexpr int ZC = 8;  // z rows per block in pass 3 (kernels/mega_ngp.py ZROWS)

// Dynamic shared memory of k_ngp_fields (floats): W1c transposed [H][LFP],
// tb1 [H][3], W2 [H][4].
inline size_t fields_smem_floats(int LF, int H) {
  const int lfp = (LF + 3) & ~3;
  return (size_t)H * lfp + (size_t)H * 7;
}

// Dynamic shared memory of k_ngp_adjoint (floats): gy [NT][8] (dF, g/2dt),
// W1c [LF][H], dW1c accumulators [LF][H], enc [LF][NT], dz1_sum [H][NT+1].
inline size_t adjoint_smem_floats(int LF, int H) {
  return (size_t)NT * 8 + 2 * (size_t)LF * H + (size_t)LF * NT + (size_t)H * (NT + 1);
}

// Pass 1. MAXLF bounds LF at compile time, so the cell's encoding stays in
// registers; LF is padded to LFP (a multiple of 4) with zeros, so the
// padded channels add exact zeros.
template <int MAXLF>
__global__ void __launch_bounds__(NT)
    k_ngp_fields(const float* __restrict__ enc, const float* __restrict__ w1c,
                 const float* __restrict__ tb1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ fbuf, int nx, int ny, int nz,
                 int LF, int H) {
  extern __shared__ float4 sh4[];
  const int lfp = (LF + 3) & ~3;
  float* w1t_s = reinterpret_cast<float*>(sh4);  // [H][lfp]
  float* tb_s = w1t_s + H * lfp;                  // [H][3]
  float* w2_s = tb_s + H * 3;                     // [H][4]
  const int tid = threadIdx.x;
  for (int i = tid; i < H * lfp; i += NT) {
    const int h = i / lfp, c = i % lfp;
    w1t_s[i] = c < LF ? w1c[c * H + h] : 0.f;
  }
  for (int i = tid; i < H * 3; i += NT) tb_s[i] = tb1[i];
  for (int i = tid; i < H * 4; i += NT) w2_s[i] = w2[i];
  __syncthreads();

  const int gx = blockIdx.x * TX + tid % TX, gy = blockIdx.y * TY + tid / TX, z = blockIdx.z;
  if (gx >= nx || gy >= ny) return;
  const size_t plane = (size_t)nx * ny, ncell = (size_t)nz * plane;
  const size_t cell = (size_t)gy * nx + gx;
  float e[MAXLF];
#pragma unroll
  for (int c = 0; c < MAXLF; ++c) e[c] = c < LF ? __ldg(enc + ((size_t)z * LF + c) * plane + cell) : 0.f;

  float acc[3][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[s][o] = 0.f;
  for (int h = 0; h < H; ++h) {
    const float4* wr = reinterpret_cast<const float4*>(w1t_s + h * lfp);
    float base = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < MAXLF / 4; ++c4) {
      if (4 * c4 < lfp) {
        const float4 w = wr[c4];
        base = fmaf(w.x, e[4 * c4], base);
        base = fmaf(w.y, e[4 * c4 + 1], base);
        base = fmaf(w.z, e[4 * c4 + 2], base);
        base = fmaf(w.w, e[4 * c4 + 3], base);
      }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float a = fmaxf(base + tb_s[h * 3 + s], 0.f);
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[s][o] = fmaf(a, w2_s[h * 4 + o], acc[s][o]);
    }
  }
  // fbuf channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11 ([sigma, u]).
  const int slot[3] = {4, 0, 8};
  const size_t at = (size_t)z * plane + cell;
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int o = 0; o < 4; ++o) fbuf[(slot[s] + o) * ncell + at] = acc[s][o] + __ldg(b2 + o);
}

// Pass 3 (see the file comment). H * nsub <= NT: each thread owns at most
// one (h, subset) item of phase B1.
template <int MAXLF>
__global__ void __launch_bounds__(NT)
    k_ngp_adjoint(const float* __restrict__ enc, const float* __restrict__ w1c,
                  const float* __restrict__ tb1, const float* __restrict__ ts,
                  const float* __restrict__ w2, const float* __restrict__ fbuf,
                  const float* __restrict__ gbuf,
                  float* __restrict__ denc, float* __restrict__ dw1_part,
                  float* __restrict__ head_part, float* __restrict__ db2_part, int nx, int ny,
                  int nz, int LF, int H, int nsub, int periodic, pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  __shared__ float red[2 * NT / 32];
  float4* gy_s = sh4;                                       // [NT][2]: dF_t, g / (2dt)
  float* w1c_s = reinterpret_cast<float*>(sh4 + NT * 2);    // [LF][H]
  float* dw1_s = w1c_s + LF * H;                            // [LF][H]
  float* enc_s = dw1_s + LF * H;                            // [LF][NT]
  float* dz_s = enc_s + LF * NT;                            // [H][NT + 1]
  constexpr int DZ = NGP_DZ;  // padded row (ngp_head.cuh)

  const int tid = threadIdx.x;
  for (int i = tid; i < LF * H; i += NT) {
    w1c_s[i] = w1c[i];
    dw1_s[i] = 0.f;
  }
  const int gx = blockIdx.x * TX + tid % TX, gy = blockIdx.y * TY + tid / TX;
  const bool valid = gx < nx && gy < ny;
  const size_t plane = (size_t)nx * ny;
  const size_t cell = valid ? (size_t)gy * nx + gx : 0;
  const int z0 = blockIdx.z * ZC, z1 = min(z0 + ZC, nz);

  // This thread's phase-B1 item: hidden unit h over one subset of the
  // tile's cells, with its W1c column, tb1 row and W2 row in registers.
  // t_0 = t - dt_m and t_2 = t + dt_p as the host rounded them.
  const int h = tid % H, sub = tid / H;
  const bool active = tid < H * nsub;
  const int cps = (NT + nsub - 1) / nsub;
  const int c_begin = sub * cps, c_end = min(NT, c_begin + cps);
  float wcol[MAXLF], tb[3], w2r[4];
#pragma unroll
  for (int c = 0; c < MAXLF; ++c) wcol[c] = active && c < LF ? __ldg(w1c + c * H + h) : 0.f;
#pragma unroll
  for (int s = 0; s < 3; ++s) tb[s] = active ? __ldg(tb1 + h * 3 + s) : 0.f;
#pragma unroll
  for (int o = 0; o < 4; ++o) w2r[o] = active ? __ldg(w2 + h * 4 + o) : 0.f;
  const float t1 = __ldg(ts + 1), dt_m = t1 - __ldg(ts), dt_p = __ldg(ts + 2) - t1;
  // db1 = sum dz1_sum; dtw1 = t1 db1 + e1, e1 = sum (dt_p dz1_tp1 - dt_m dz1_tm1)
  float db1 = 0.f, e1 = 0.f, dw2[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};

  for (int z = z0; z < z1; ++z) {
    // ---- A: field cotangents and the encoding of the row -------------------
    float4 gt = make_float4(0.f, 0.f, 0.f, 0.f), gq = gt;
    if (valid) {
      float d[4], gc[4];
      pat::t_slice_adjoint(fbuf, gbuf, gx, gy, z, nx, ny, nz, periodic, k, d, gc);
      gt = make_float4(d[0], d[1], d[2], d[3]);
      gq = make_float4(k.inv2dt * gc[0], k.inv2dt * gc[1], k.inv2dt * gc[2], k.inv2dt * gc[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) db[c] += d[c];
    }
    gy_s[tid * 2] = gt;      // gy of the t slice
    gy_s[tid * 2 + 1] = gq;  // gy of t+dt; t-dt's is its negative
    for (int c = 0; c < LF; ++c)
      enc_s[c * NT + tid] = valid ? __ldg(enc + ((size_t)z * LF + c) * plane + cell) : 0.f;
    __syncthreads();

    // ---- B1: the head backward, h-major -------------------------------------
    if (active) {
      for (int cl = c_begin; cl < c_end; ++cl) {
        const int cx = blockIdx.x * TX + cl % TX, cy = blockIdx.y * TY + cl / TX;
        float dzsum = 0.f;
        if (cx < nx && cy < ny) {
          float base = 0.f;
#pragma unroll
          for (int c = 0; c < MAXLF; ++c)
            if (c < LF) base = fmaf(wcol[c], enc_s[c * NT + cl], base);
          const float4 f = gy_s[cl * 2], q = gy_s[cl * 2 + 1];
          const float am = fmaxf(base + tb[0], 0.f);
          const float at = fmaxf(base + tb[1], 0.f);
          const float ap = fmaxf(base + tb[2], 0.f);
          const float pt = w2r[0] * f.x + w2r[1] * f.y + w2r[2] * f.z + w2r[3] * f.w;
          const float pq = w2r[0] * q.x + w2r[1] * q.y + w2r[2] * q.z + w2r[3] * q.w;
          const float dm = am > 0.f ? -pq : 0.f;
          const float dt = at > 0.f ? pt : 0.f;
          const float dp = ap > 0.f ? pq : 0.f;
          dzsum = dt + (dm + dp);
          db1 += dzsum;
          e1 = fmaf(dt_p, dp, fmaf(-dt_m, dm, e1));
          const float dif = ap - am;
          dw2[0] += at * f.x + dif * q.x;
          dw2[1] += at * f.y + dif * q.y;
          dw2[2] += at * f.z + dif * q.z;
          dw2[3] += at * f.w + dif * q.w;
        }
        dz_s[h * DZ + cl] = dzsum;
      }
    }
    __syncthreads();

    // ---- B2: dEnc of the row, thread per cell -------------------------------
    if (denc != nullptr && valid)
      ngp_denc_cell(denc + (size_t)z * LF * plane + cell, plane, w1c_s, dz_s, LF, H);
    // ---- B3: dW1c += enc^T dz1_sum over the row's cells ---------------------
    ngp_dw1_row(dw1_s, enc_s, dz_s, LF, H);
    __syncthreads();  // the next row overwrites gy_s, enc_s and dz_s
  }

  // ---- the block's partials -------------------------------------------------
  const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t blk = (size_t)blockIdx.z * ntiles + tile;
  for (int j = tid; j < LF * H; j += NT) dw1_part[blk * LF * H + j] = dw1_s[j];
  if (active) {
    float* hp = head_part + ((blk * nsub + sub) * H + h) * 6;
    hp[0] = db1;
    hp[1] = fmaf(t1, db1, e1);
#pragma unroll
    for (int o = 0; o < 4; ++o) hp[2 + o] = dw2[o];
  }
  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[blk * 4 + c] = db[c];
  }
}

template <int MAXLF>
cudaError_t launch_ngp(const float* enc, const float* w1c, const float* tb1, const float* ts,
                       const float* w2, const float* b2, float* fbuf, float* gbuf,
                       float* tile_parts, float* dw1_part, float* head_part, float* db2_part, float* denc,
                       float* dw1c, float* dhead, float* db2, int nx, int ny, int nz, int LF, int H,
                       int nsub, int periodic, const pat::StencilConsts& k, float scale_sigma,
                       float scale_u, cudaStream_t s) {
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nzr = (nz + ZC - 1) / ZC;
  const size_t ncell = (size_t)nz * ny * nx;
  cudaError_t err;

  const size_t smem1 = fields_smem_floats(LF, H) * sizeof(float);
  cudaFuncSetAttribute(k_ngp_fields<MAXLF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  k_ngp_fields<MAXLF><<<dim3(ntx, nty, nz), NT, smem1, s>>>(enc, w1c, tb1, w2, b2, fbuf, nx, ny, nz,
                                                             LF, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // K1's channel order (PACKED_ORDER) over fbuf's slots: t 0..3, t-dt 4..7,
  // t+dt 8..11.
  const float* f = fbuf;
  const FieldPtrs fp{{f + 4 * ncell, f, f + 8 * ncell, f + 5 * ncell, f + 6 * ncell, f + 7 * ncell,
                      f + ncell, f + 2 * ncell, f + 3 * ncell, f + 9 * ncell, f + 10 * ncell,
                      f + 11 * ncell}};
  const OutPtrs op{{gbuf, gbuf + ncell, gbuf + 2 * ncell, gbuf + 3 * ncell}};
  k_residuals<MODE_SCALED_PARTIALS><<<dim3(ntx, nty, nz), NT, 0, s>>>(
      fp, op, tile_parts, nx, ny, nz, periodic, k, scale_sigma, scale_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = adjoint_smem_floats(LF, H) * sizeof(float);
  cudaFuncSetAttribute(k_ngp_adjoint<MAXLF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  k_ngp_adjoint<MAXLF><<<dim3(ntx, nty, nzr), NT, smem3, s>>>(
      enc, w1c, tb1, ts, w2, fbuf, gbuf, denc, dw1_part, head_part, db2_part, nx, ny, nz, LF, H, nsub,
      periodic, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int nblk = ntx * nty * nzr;
  k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_sum_parts<<<H * 6, NT, 0, s>>>(head_part, dhead, H * 6, nblk * nsub);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return cudaGetLastError();
}

}  // namespace

// enc [nz, LF, ny, nx], W1c [LF, H], tb1 [H, 3], ts [3], W2 [H, 4], b2 [4];
// scratch fbuf [12, N], gbuf [4, N], tile partials [2, nz, ntiles], dW1c
// partials [nblk, LF, H], (db1, dtw1, dW2) partials [nblk * nsub, H, 6], db2
// partials [nblk, 4]; outputs dEnc (or null), dW1c [LF, H], dhead [H, 6] =
// (db1, dtw1, dW2) side by side, db2 [4]. LF <= 64 and H * nsub <= 256 (the
// host gates).
extern "C" int pat_mega_ngp(const float* enc, const float* w1c, const float* tb1, const float* ts,
                            const float* w2, const float* b2, float* fbuf, float* gbuf,
                            float* tile_parts, float* dw1_part, float* head_part, float* db2_part, float* denc,
                            float* dw1c, float* dhead, float* db2, int nx, int ny, int nz, int LF,
                            int H, int nsub, int periodic, int upwind, float inv2dt, float inv2hx,
                            float inv2hy, float inv2hz, float scale_sigma, float scale_u,
                            void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  cudaStream_t s = (cudaStream_t)stream;
  if (H < 1 || H * nsub > NT || LF < 1) return (int)cudaErrorInvalidValue;
#define PAT_NGP_ARGS                                                                           \
  enc, w1c, tb1, ts, w2, b2, fbuf, gbuf, tile_parts, dw1_part, head_part, db2_part, denc, dw1c,  \
      dhead, db2, nx, ny, nz, LF, H, nsub, periodic, k, scale_sigma, scale_u, s
  if (LF <= 16) return (int)launch_ngp<16>(PAT_NGP_ARGS);
  if (LF <= 32) return (int)launch_ngp<32>(PAT_NGP_ARGS);
  if (LF <= 64) return (int)launch_ngp<64>(PAT_NGP_ARGS);
#undef PAT_NGP_ARGS
  return (int)cudaErrorInvalidValue;
}
