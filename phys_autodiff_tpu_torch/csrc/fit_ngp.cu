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
// adjoint: a cell's cotangent is its own error. Launches, no float atomics:
//   1. k_ngp_fit: a block owns a 32 x 8 (x, y) tile and ZC z rows and walks
//      them one row at a time:
//      A  thread per cell: the cell's encoding goes to registers and to
//         shared memory; the head forward (W1c transposed in shared memory,
//         read as float4), e, gy (to shared memory) and the row's loss
//         tile partials (block sums).
//      B1 thread (h, cell subset), h-major as K5's B1: recompute base[h]
//         from the row's encoding (the [N, H] activations are never
//         stored); db1[h] and dW2[h, :] accumulate in registers over every
//         cell the thread visits; dz1[h, cell] goes to shared memory.
//      B2 thread per cell: dEnc (ngp_head.cuh, shared with K5).
//      B3 thread per (c, h): dW1c in shared memory over the rows
//         (ngp_head.cuh).
//      Each block writes its partials.
//   2. k_sum_parts (ngp_head.cuh): dW1c, (db1, dW2) and db2 added in a fixed
//      order.
//
// Bound on this card: FP32 operations. The function needs 6 LF H + 28 H + 23
// operations a cell, an FMA counted as two: forward base 2 LF H, the bias,
// the ReLU and y 10 H; backward W2 . gy 8 H, the mask H, db1 H, dW2 8 H,
// dW1c and dEnc 2 LF H each; e, the squares, gy and db2 23. At LF = 16,
// H = 64 on 128x96x96 that is 9.39 GFLOP, 0.140 ms at 67 TFLOP/s. The
// compulsory bytes are enc and dEnc (75.5 MB each) and the target (18.9 MB),
// 0.051 ms at 3.35 TB/s. This first version runs FFMA on the CUDA cores and
// feeds B1-B3 from shared memory, as K5 does; it recomputes base in B1
// (2 LF H more a cell).

#include "ngp_head.cuh"

namespace {

constexpr int TX = pat::TILE_X, TY = pat::TILE_Y, NT = pat::TILE_THREADS;
constexpr int ZC = 8;  // z rows per block (kernels/fit.py ZROWS)
constexpr int DZ = NGP_DZ;

// Dynamic shared memory of k_ngp_fit (floats): gy [NT] (float4), W1c [LF][H],
// dW1c accumulators [LF][H], enc [LF][NT], dz1 [H][NT + 1], W1c transposed
// [H][LFP] (LF padded to a multiple of 4 with zeros), tb1 [H], W2 [H][4].
inline size_t ngp_fit_smem_floats(int LF, int H) {
  const int lfp = (LF + 3) & ~3;
  return (size_t)NT * 4 + 2 * (size_t)LF * H + (size_t)LF * NT + (size_t)H * DZ +
         (size_t)H * lfp + 5 * (size_t)H;
}

// H * nsub <= NT: each thread owns at most one (h, subset) item of B1.
template <int MAXLF>
__global__ void __launch_bounds__(NT)
    k_ngp_fit(const float* __restrict__ enc, const float* __restrict__ w1c,
              const float* __restrict__ tb1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ tgt,
              float* __restrict__ denc, float* __restrict__ tile_parts,
              float* __restrict__ dw1_part, float* __restrict__ head_part,
              float* __restrict__ db2_part, int nx, int ny, int nz, int LF, int H, int nsub,
              float scale_sigma, float scale_u) {
  extern __shared__ float4 sh4[];
  const int lfp = (LF + 3) & ~3;
  float4* gy_s = sh4;                                     // [NT]
  float* w1c_s = reinterpret_cast<float*>(sh4 + NT);      // [LF][H]
  float* dw1_s = w1c_s + LF * H;                          // [LF][H]
  float* enc_s = dw1_s + LF * H;                          // [LF][NT]
  float* dz_s = enc_s + LF * NT;                          // [H][DZ]
  float* w1t_s = dz_s + H * DZ;                           // [H][lfp]
  float* tb_s = w1t_s + H * lfp;                          // [H]
  float* w2_s = tb_s + H;                                 // [H][4]
  __shared__ float red[2 * NT / 32];

  const int tid = threadIdx.x;
  for (int i = tid; i < LF * H; i += NT) {
    w1c_s[i] = w1c[i];
    dw1_s[i] = 0.f;
  }
  for (int i = tid; i < H * lfp; i += NT) {
    const int h = i / lfp, c = i % lfp;
    w1t_s[i] = c < LF ? w1c[c * H + h] : 0.f;
  }
  for (int i = tid; i < H; i += NT) tb_s[i] = tb1[i];
  for (int i = tid; i < 4 * H; i += NT) w2_s[i] = w2[i];
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};

  const int gx = blockIdx.x * TX + tid % TX, gy = blockIdx.y * TY + tid / TX;
  const bool valid = gx < nx && gy < ny;
  const size_t plane = (size_t)nx * ny;
  const size_t cell = valid ? (size_t)gy * nx + gx : 0;
  const int z0 = blockIdx.z * ZC, z1 = min(z0 + ZC, nz);

  // This thread's B1 item: hidden unit h over one subset of the tile's
  // cells, with its W1c column, tb1 and W2 row in registers.
  const int h = tid % H, sub = tid / H;
  const bool active = tid < H * nsub;
  const int cps = (NT + nsub - 1) / nsub;
  const int c_begin = sub * cps, c_end = min(NT, c_begin + cps);
  float wcol[MAXLF], w2r[4];
#pragma unroll
  for (int c = 0; c < MAXLF; ++c) wcol[c] = active && c < LF ? __ldg(w1c + c * H + h) : 0.f;
#pragma unroll
  for (int o = 0; o < 4; ++o) w2r[o] = active ? __ldg(w2 + h * 4 + o) : 0.f;
  const float tb = active ? __ldg(tb1 + h) : 0.f;
  float db1 = 0.f, dw2[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  __syncthreads();

  for (int z = z0; z < z1; ++z) {
    // ---- A: the row's encoding, the head forward, e and gy ---------------
    float e[MAXLF];
#pragma unroll
    for (int c = 0; c < MAXLF; ++c) {
      e[c] = valid && c < LF ? __ldg(enc + ((size_t)z * LF + c) * plane + cell) : 0.f;
      if (c < LF) enc_s[c * NT + tid] = e[c];
    }
    float a = 0.f, b = 0.f;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      for (int hh = 0; hh < H; ++hh) {
        const float4* wr = reinterpret_cast<const float4*>(w1t_s + hh * lfp);
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
        const float act = fmaxf(base + tb_s[hh], 0.f);
#pragma unroll
        for (int o = 0; o < 4; ++o) y[o] = fmaf(act, w2_s[hh * 4 + o], y[o]);
      }
      const float* tp = tgt + (size_t)z * 4 * plane + cell;
      const float e0 = (y[0] + b2r[0]) - __ldg(tp);
      const float e1 = (y[1] + b2r[1]) - __ldg(tp + plane);
      const float e2 = (y[2] + b2r[2]) - __ldg(tp + 2 * plane);
      const float e3 = (y[3] + b2r[3]) - __ldg(tp + 3 * plane);
      a = e0 * e0;
      b = (e1 * e1 + e2 * e2) + e3 * e3;
      g = make_float4(scale_sigma * e0, scale_u * e1, scale_u * e2, scale_u * e3);
      db[0] += g.x;
      db[1] += g.y;
      db[2] += g.z;
      db[3] += g.w;
    }
    gy_s[tid] = g;
    pat::block_sum2<NT>(a, b, red);
    if (tid == 0) {
      tile_parts[(size_t)z * ntiles + tile] = a;
      tile_parts[((size_t)nz + z) * ntiles + tile] = b;
    }
    __syncthreads();  // enc_s and gy_s complete; red free again

    // ---- B1: the head backward, h-major -------------------------------------
    if (active) {
      for (int cl = c_begin; cl < c_end; ++cl) {
        const int cx = blockIdx.x * TX + cl % TX, cy = blockIdx.y * TY + cl / TX;
        float dz = 0.f;
        if (cx < nx && cy < ny) {
          float base = 0.f;
#pragma unroll
          for (int c = 0; c < MAXLF; ++c)
            if (c < LF) base = fmaf(wcol[c], enc_s[c * NT + cl], base);
          const float4 q = gy_s[cl];
          const float at = fmaxf(base + tb, 0.f);
          const float p = w2r[0] * q.x + w2r[1] * q.y + w2r[2] * q.z + w2r[3] * q.w;
          dz = at > 0.f ? p : 0.f;
          db1 += dz;
          dw2[0] += at * q.x;
          dw2[1] += at * q.y;
          dw2[2] += at * q.z;
          dw2[3] += at * q.w;
        }
        dz_s[h * DZ + cl] = dz;
      }
    }
    __syncthreads();

    // ---- B2: dEnc of the row; B3: dW1c += enc^T dz1 ---------------------------
    if (denc != nullptr && valid) ngp_denc_cell(denc + (size_t)z * LF * plane + cell, plane, w1c_s, dz_s, LF, H);
    ngp_dw1_row(dw1_s, enc_s, dz_s, LF, H);
    __syncthreads();  // the next row overwrites gy_s, enc_s and dz_s
  }

  // ---- the block's partials ---------------------------------------------------
  const size_t blk = (size_t)blockIdx.z * ntiles + tile;
  for (int j = tid; j < LF * H; j += NT) dw1_part[blk * LF * H + j] = dw1_s[j];
  if (active) {
    float* hp = head_part + ((blk * nsub + sub) * H + h) * 5;
    hp[0] = db1;
#pragma unroll
    for (int o = 0; o < 4; ++o) hp[1 + o] = dw2[o];
  }
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[blk * 4 + c] = db[c];
  }
}

template <int MAXLF>
cudaError_t launch_ngp_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                           const float* b2, const float* tgt, float* tile_parts, float* dw1_part,
                           float* head_part, float* db2_part, float* denc, float* dw1c,
                           float* dhead, float* db2, int nx, int ny, int nz, int LF, int H,
                           int nsub, float scale_sigma, float scale_u, cudaStream_t s) {
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nzr = (nz + ZC - 1) / ZC;
  const size_t smem = ngp_fit_smem_floats(LF, H) * sizeof(float);
  cudaFuncSetAttribute(k_ngp_fit<MAXLF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_ngp_fit<MAXLF><<<dim3(ntx, nty, nzr), NT, smem, s>>>(
      enc, w1c, tb1, w2, b2, tgt, denc, tile_parts, dw1_part, head_part, db2_part, nx, ny, nz, LF,
      H, nsub, scale_sigma, scale_u);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nblk = ntx * nty * nzr;
  k_sum_parts<<<LF * H, NT, 0, s>>>(dw1_part, dw1c, LF * H, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_sum_parts<<<H * 5, NT, 0, s>>>(head_part, dhead, H * 5, nblk * nsub);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k_sum_parts<<<4, NT, 0, s>>>(db2_part, db2, 4, nblk);
  return cudaGetLastError();
}

}  // namespace

// enc [nz, LF, ny, nx], W1c [LF, H] (the leading rows of W1), tb1 [H],
// W2 [H, 4], b2 [4], target [nz, 4, ny*nx]; scratch: tile partials
// [2, nz, ntiles], dW1c partials [nblk, LF, H], (db1, dW2) partials
// [nblk * nsub, H, 5], db2 partials [nblk, 4]; outputs dEnc (or null), dW1c
// [LF, H], dhead [H, 5] = (db1, dW2) side by side, db2 [4]. LF <= 64 and
// H * nsub <= 256 (the host gates).
extern "C" int pat_ngp_fit(const float* enc, const float* w1c, const float* tb1, const float* w2,
                           const float* b2, const float* tgt, float* tile_parts, float* dw1_part,
                           float* head_part, float* db2_part, float* denc, float* dw1c,
                           float* dhead, float* db2, int nx, int ny, int nz, int LF, int H,
                           int nsub, float scale_sigma, float scale_u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H < 1 || H * nsub > NT || LF < 1) return (int)cudaErrorInvalidValue;
#define PAT_NGP_FIT_ARGS                                                                        \
  enc, w1c, tb1, w2, b2, tgt, tile_parts, dw1_part, head_part, db2_part, denc, dw1c, dhead, db2, \
      nx, ny, nz, LF, H, nsub, scale_sigma, scale_u, s
  if (LF <= 16) return (int)launch_ngp_fit<16>(PAT_NGP_FIT_ARGS);
  if (LF <= 32) return (int)launch_ngp_fit<32>(PAT_NGP_FIT_ARGS);
  if (LF <= 64) return (int)launch_ngp_fit<64>(PAT_NGP_FIT_ARGS);
#undef PAT_NGP_FIT_ARGS
  return (int)cudaErrorInvalidValue;
}
