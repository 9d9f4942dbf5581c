// K6: the supervised-fit kernel of the coordinate MLP (the data loss and
// every MLP table gradient in one call), sm_90a.
//
// Replaces _build_fit_call of phys_autodiff_tpu/pallas/fit.py (:68). From the
// folded tables of K2 (AB [H, ny, nx], CD [nz, H, 1] at the one slice t,
// W2T [4, H], b2 [4]) and the packed target [nz, 4, ny * nx] it computes, per
// cell,
//   y = W2T relu(AB + CD[z]) + b2,  e = y - target,
//   gy = (2w/N) e (w_sigma on channel 0, w_u on 1..3),
//   dz1 = [AB + CD[z] > 0] W2 gy,  dAB += dz1 (over z),  dCD[z] += dz1 (over
//   cells),  dW2T += gy relu(AB + CD[z])^T,  db2 += gy,
// and the per-(z plane, tile) loss partials sum e_sigma^2 and sum |e_u|^2.
// The host adds those in a fixed order (kernels/residuals.finalize_partials)
// and pulls (dAB, dCD, dW2T, db2) back through the folds to (W1, b1, W2, b2,
// t) by autograd.
//
// K6 is K4 (mega_bwd.cu) without the stencil: a cell's cotangent needs no
// neighbour, so the forward and the backward share one block and nothing
// grid-sized but the gradient partials reaches device memory.
//   1. k_fit: a block owns a 32 x 8 (x, y) tile and ZC z rows.
//      Phase A, thread per cell: read AB[h, cell] once for the ZC rows (CD
//      rows and W2T in shared memory), evaluate y for every row, form e and
//      gy, write the row's loss tile partials (block sums) and put gy in
//      shared memory.
//      Phase B, K4's MLP backward for one slice: thread (h, cell subset)
//      walks its cells with the ZC rows innermost, keeps dCD[z, h] and
//      dW2T[:, h] in registers and writes dAB[h, cell] summed over its rows,
//      one partial per z range.
//   2. k_bwd_finalize<1>, k_bwd_reduce (mlp_bwd.cuh, shared with K4): the
//      partials added in a fixed order, no atomics.
//
// Bound on this card: FP32 operations. The function needs 29 H + 23
// operations a cell, an FMA counted as two: forward 10 H (add, max, 4 FMA);
// backward W2 . gy 8 H, the mask H, dAB H, dCD H, dW2 8 H; e, the squares,
// gy and db2 23. At H = 128 on 128x96x96 that is 4.41 GFLOP, 0.066 ms at
// 67 TFLOP/s. The compulsory bytes are the target (18.9 MB) and AB and dAB
// (6.3 MB each), 0.009 ms at 3.35 TB/s. This first version recomputes
// relu(AB + CD) in phase B (2 H more a cell), reads AB once a phase through
// L2, and runs FFMA on the CUDA cores.

#include "mlp_bwd.cuh"

namespace {

constexpr int TX = pat::TILE_X, TY = pat::TILE_Y, NT = pat::TILE_THREADS;
constexpr int ZC = 8;  // z rows per block (kernels/fit.py ZROWS)

// Dynamic shared memory of k_fit (bytes): gy [ZC][NT] (float4), CD rows
// [ZC][H] (zero past the grid), W2T [4][H], b2 [4].
inline size_t fit_smem_bytes(int H) {
  return (size_t)ZC * NT * sizeof(float4) + ((size_t)ZC * H + 4 * (size_t)H + 4) * sizeof(float);
}

__global__ void __launch_bounds__(NT, 2)
    k_fit(const float* __restrict__ ab, const float* __restrict__ cd,
          const float* __restrict__ w2t, const float* __restrict__ b2,
          const float* __restrict__ tgt, float* __restrict__ tile_parts,
          float* __restrict__ dab_part, float* __restrict__ dcd_part,
          float* __restrict__ dw2_part, float* __restrict__ db2_part, int nx, int ny, int nz,
          int H, int nsub, float scale_sigma, float scale_u) {
  extern __shared__ float4 sh4[];
  float4* gy_s = sh4;                                        // [ZC][NT]
  float* cd_s = reinterpret_cast<float*>(sh4 + ZC * NT);     // [ZC][H]
  float* w2_s = cd_s + ZC * H;                               // [4][H]
  float* b2_s = w2_s + 4 * H;                                // [4]
  __shared__ float red[2 * NT / 32];

  const int tid = threadIdx.x;
  const int gx = blockIdx.x * TX + tid % TX, gy = blockIdx.y * TY + tid / TX;
  const bool valid = gx < nx && gy < ny;
  const int plane = nx * ny;
  const int z0 = blockIdx.z * ZC, nrow = min(ZC, nz - z0);
  for (int i = tid; i < ZC * H; i += NT) cd_s[i] = i < nrow * H ? cd[(size_t)z0 * H + i] : 0.f;
  for (int i = tid; i < 4 * H; i += NT) w2_s[i] = w2t[i];
  if (tid < 4) b2_s[tid] = b2[tid];
  __syncthreads();

  // ---- phase A: the forward of every row, e, gy and the loss partials ------
  const int cell = valid ? gy * nx + gx : 0;
  float acc[ZC][4];
#pragma unroll
  for (int zl = 0; zl < ZC; ++zl)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[zl][o] = 0.f;
  if (valid) {
    const float* abp = ab + cell;
#pragma unroll 2
    for (int h = 0; h < H; ++h) {
      const float a = __ldg(abp + (size_t)h * plane);
      const float w0 = w2_s[h], w1 = w2_s[H + h], w2 = w2_s[2 * H + h], w3 = w2_s[3 * H + h];
#pragma unroll
      for (int zl = 0; zl < ZC; ++zl) {
        const float act = fmaxf(a + cd_s[zl * H + h], 0.f);
        acc[zl][0] = fmaf(act, w0, acc[zl][0]);
        acc[zl][1] = fmaf(act, w1, acc[zl][1]);
        acc[zl][2] = fmaf(act, w2, acc[zl][2]);
        acc[zl][3] = fmaf(act, w3, acc[zl][3]);
      }
    }
  }

  const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  float db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int zl = 0; zl < ZC; ++zl) {
    if (zl < nrow) {  // uniform over the block
      const int z = z0 + zl;
      float a = 0.f, b = 0.f;
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const float* tp = tgt + (size_t)z * 4 * plane + cell;
        const float e0 = (acc[zl][0] + b2_s[0]) - __ldg(tp);
        const float e1 = (acc[zl][1] + b2_s[1]) - __ldg(tp + plane);
        const float e2 = (acc[zl][2] + b2_s[2]) - __ldg(tp + 2 * plane);
        const float e3 = (acc[zl][3] + b2_s[3]) - __ldg(tp + 3 * plane);
        a = e0 * e0;
        b = (e1 * e1 + e2 * e2) + e3 * e3;
        g = make_float4(scale_sigma * e0, scale_u * e1, scale_u * e2, scale_u * e3);
        db[0] += g.x;
        db[1] += g.y;
        db[2] += g.z;
        db[3] += g.w;
      }
      gy_s[zl * NT + tid] = g;
      pat::block_sum2<NT>(a, b, red);
      if (tid == 0) {
        tile_parts[(size_t)z * ntiles + tile] = a;
        tile_parts[((size_t)nz + z) * ntiles + tile] = b;
      }
      __syncthreads();  // red is reused
    }
  }
  const int blk = blockIdx.z * ntiles + tile;
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[(size_t)blk * 4 + c] = db[c];
  }
  __syncthreads();  // gy_s complete

  // ---- phase B: the MLP backward, h-major (K4's phase B, one slice) -------
  const int cps = (NT + nsub - 1) / nsub;
  for (int item = tid; item < H * nsub; item += NT) {
    const int h = item % H, sub = item / H;
    const float w0 = w2_s[h], w1 = w2_s[H + h], w2 = w2_s[2 * H + h], w3 = w2_s[3 * H + h];
    float cdz[ZC], dcd[ZC];
#pragma unroll
    for (int zl = 0; zl < ZC; ++zl) {
      cdz[zl] = cd_s[zl * H + h];
      dcd[zl] = 0.f;
    }
    float dw[4] = {0.f, 0.f, 0.f, 0.f};
    const int c_end = min(NT, (sub + 1) * cps);
    for (int c = sub * cps; c < c_end; ++c) {
      const int cx = blockIdx.x * TX + c % TX, cy = blockIdx.y * TY + c / TX;
      if (cx >= nx || cy >= ny) continue;
      const int cl = cy * nx + cx;
      const float a = __ldg(ab + (size_t)h * plane + cl);
      float dab = 0.f;
#pragma unroll
      for (int zl = 0; zl < ZC; ++zl) {
        if (zl < nrow) {
          const float4 g = gy_s[zl * NT + c];
          const float at = fmaxf(a + cdz[zl], 0.f);
          const float p = w0 * g.x + w1 * g.y + w2 * g.z + w3 * g.w;
          const float d = at > 0.f ? p : 0.f;
          dcd[zl] += d;
          dab += d;
          dw[0] += at * g.x;
          dw[1] += at * g.y;
          dw[2] += at * g.z;
          dw[3] += at * g.w;
        }
      }
      dab_part[((size_t)blockIdx.z * H + h) * plane + cl] = dab;
    }
    const size_t psub = (size_t)tile * nsub + sub, np = (size_t)ntiles * nsub;
#pragma unroll
    for (int zl = 0; zl < ZC; ++zl)
      if (zl < nrow) dcd_part[(((size_t)(z0 + zl)) * np + psub) * H + h] = dcd[zl];
#pragma unroll
    for (int o = 0; o < 4; ++o) dw2_part[(((size_t)blk * nsub + sub) * 4 + o) * H + h] = dw[o];
  }
}

}  // namespace

// AB [H, ny, nx], CD [nz, H, 1], W2T [4, H], b2 [4], target [nz, 4, ny*nx];
// scratch: tile partials [2, nz, ntiles], dAB partials [nzr, H, ny, nx], dCD
// partials [nz, ntiles * nsub, H], dW2T partials [nblk * nsub, 4, H], db2
// partials [nblk, 4]; outputs dAB [H, ny, nx], dCD [nz, H, 1], dW2T [4, H],
// db2 [4].
extern "C" int pat_fit(const float* ab, const float* cd, const float* w2t, const float* b2,
                       const float* tgt, float* tile_parts, float* dab_part, float* dcd_part,
                       float* dw2_part, float* db2_part, float* dab, float* dcd, float* dw2t,
                       float* db2, int nx, int ny, int nz, int H, int nsub, float scale_sigma,
                       float scale_u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H < 1 || nsub < 1) return (int)cudaErrorInvalidValue;
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nzr = (nz + ZC - 1) / ZC;
  const size_t smem = fit_smem_bytes(H);
  cudaFuncSetAttribute(k_fit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_fit<<<dim3(ntx, nty, nzr), NT, smem, s>>>(ab, cd, w2t, b2, tgt, tile_parts, dab_part,
                                              dcd_part, dw2_part, db2_part, nx, ny, nz, H, nsub,
                                              scale_sigma, scale_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd_sums<1>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2,
                                 nx * ny, nz, H, nzr, ntx * nty, nsub, s);
}
