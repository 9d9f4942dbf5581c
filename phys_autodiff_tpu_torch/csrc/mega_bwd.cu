// K4: the backward mega-kernel (the loss and every MLP table gradient), sm_90a.
//
// Replaces _build_bwd_call of phys_autodiff_tpu/pallas/mega_bwd.py (:568).
// From the folded tables of K2 / K3 (AB [H, ny, nx], CD [nz, H, 3],
// W2T [4, H], b2 [4]) it computes the per-(z plane, tile) loss partials and
// dAB, dCD, dW2T, db2; the host pulls those back through the folds to
// (W1, b1, W2, b2, t).
//
// Four launches, and no float atomics: every sum has a fixed order, so the
// gradients are the same bits from run to run.
//   1. k_mega<true> (mega.cuh): K3's body. Besides the loss tile partials it
//      writes the scaled residual cotangents g = (2w/N) R and the t slice of
//      the fields, each [4, nz, ny, nx] (19 MB at 128x96x96).
//   2. k_mega_adjoint: a block owns a 32 x 8 (x, y) tile and ZC z rows.
//      Phase A, per row: read the t-slice fields and g at the cell and its
//      six neighbours, and apply the hand-derived adjoint of the stencil
//      (adjoint.cuh: central or upwind, periodic or clamp) in gather form: the field cotangents dF_t [4] of
//      the t slice. Those of t -+ dt are -+ g/(2dt). Both go to shared
//      memory. (Recomputing the t slice here instead, with the x/y halo
//      that K3 recomputes, took 0.41 of the pass's 1.0 ms on an H100.)
//      Phase B, the MLP backward: thread
//      (h, cell subset) walks its cells with the ZC rows innermost, so it
//      reads AB[h, cell] once for ZC rows, keeps dCD[z, h, :] and dW2T[:, h]
//      in registers (sums over cells run in-thread: no cross-thread
//      reduction) and writes dAB[h, cell] summed over its rows, one partial
//      per z range.
//   3. k_bwd_finalize, k_bwd_reduce (mlp_bwd.cuh, shared with K6): add the
//      partials in a fixed order: dAB over z ranges, dCD over (tile,
//      subset), dW2T over (block, subset), db2 over blocks.
//
// Bound on this card: FP32 instructions. Phase B costs about 40 operations
// per (cell, z row, hidden unit), 6 G at H = 128 on 128x96x96, against
// about 3 G in pass 1 (K3's three-slice MLP). The memory traffic is small
// beside that: g and the t slice (38 MB written, read through L1/L2), the
// dAB partials (nz/ZC x H x ny x nx x 4 B, 75 MB at the flagship) and AB
// (read once per z range).
//
// The clamp z edge at nz = 1: the forward z difference is identically 0
// there, so its adjoint is 0. The gather form of adjoint.cuh gives exactly
// that; the TPU kernel's edge legs do not (ROADMAP.md Queue C, R4).

#include "adjoint.cuh"
#include "mega.cuh"
#include "mlp_bwd.cuh"

namespace {

constexpr int ZC = 8;  // z rows per block (kernels/mega_bwd.py ZROWS)

// Dynamic shared memory of k_mega_adjoint (bytes): the phase-B buffer.
constexpr size_t ADJOINT_SMEM = (size_t)ZC * NT * 8 * sizeof(float);

// Two blocks an SM: ptxas then keeps the pass to 100 registers without
// spills (at 151 unbounded, one block fits); three or four blocks spill and
// ran slower on an H100.
__global__ void __launch_bounds__(NT, 2)
    k_mega_adjoint(const float* __restrict__ ab, const float* __restrict__ cd,
                   const float* __restrict__ w2t, const float* __restrict__ fbuf,
                   const float* __restrict__ gbuf, float* __restrict__ dab_part,
                   float* __restrict__ dcd_part, float* __restrict__ dw2_part,
                   float* __restrict__ db2_part, int nx, int ny, int nz, int H, int nsub,
                   int periodic, pat::StencilConsts k) {
  extern __shared__ float4 gy_s[];  // [ZC][NT][2]: dF_t, g / (2dt)
  __shared__ float red[2 * NT / 32];

  const int tid = threadIdx.x;
  const int gx = blockIdx.x * TX + tid % TX, gy = blockIdx.y * TY + tid / TX;
  const bool valid = gx < nx && gy < ny;
  const int plane = nx * ny;
  const int z0 = blockIdx.z * ZC, z1 = min(z0 + ZC, nz), nrow = z1 - z0;

  // ---- phase A: field cotangents of every cell of the tile and z range ----
  // The t-slice fields F and the cotangents G, both written by pass 1, at
  // the cell and its six neighbours (adjoint.cuh).
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  for (int z = z0; z < z1; ++z) {
    const int zl = z - z0;
    float4 df = make_float4(0.f, 0.f, 0.f, 0.f), gq = df;
    if (valid) {
      float d[4], gc[4];
      pat::t_slice_adjoint(fbuf, gbuf, gx, gy, z, nx, ny, nz, periodic, k, d, gc);
      df = make_float4(d[0], d[1], d[2], d[3]);
      gq = make_float4(k.inv2dt * gc[0], k.inv2dt * gc[1], k.inv2dt * gc[2], k.inv2dt * gc[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) db[c] += d[c];
    }
    gy_s[(zl * NT + tid) * 2] = df;
    gy_s[(zl * NT + tid) * 2 + 1] = gq;
  }

  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int blk = blockIdx.z * ntiles + tile;
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db2_part[(size_t)blk * 4 + c] = db[c];
  }
  __syncthreads();  // gy_s complete

  // ---- phase B: the MLP backward ----------------------------------------
  // y_s = W2^T relu(AB + CD[z, :, s]) + b2 for the slices s = t-dt, t, t+dt,
  // with cotangents gy_tm1 = -g/(2dt), gy_t = dF_t, gy_tp1 = +g/(2dt):
  //   dz1_s = [AB + CD_s > 0] (W2 gy_s),  dAB += sum_s dz1_s,  dCD_s += dz1_s,
  //   dW2T += sum_s relu(z1_s) gy_s^T.
  const int cps = (NT + nsub - 1) / nsub;
  for (int item = tid; item < H * nsub; item += NT) {
    const int h = item % H, sub = item / H;
    const float w0 = __ldg(w2t + h), w1 = __ldg(w2t + H + h), w2 = __ldg(w2t + 2 * H + h),
                w3 = __ldg(w2t + 3 * H + h);
    float cdz[ZC][3], dcd[ZC][3];
#pragma unroll
    for (int zl = 0; zl < ZC; ++zl)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        cdz[zl][s] = zl < nrow ? __ldg(cd + (size_t)(z0 + zl) * H * 3 + h * 3 + s) : 0.f;
        dcd[zl][s] = 0.f;
      }
    float dw[4] = {0.f, 0.f, 0.f, 0.f};
    const int c_end = min(NT, (sub + 1) * cps);
    for (int c = sub * cps; c < c_end; ++c) {
      const int cx = blockIdx.x * TX + c % TX, cy = blockIdx.y * TY + c / TX;
      if (cx >= nx || cy >= ny) continue;
      const int cell = cy * nx + cx;
      const float a = __ldg(ab + (size_t)h * plane + cell);
      float dab = 0.f;
#pragma unroll
      for (int zl = 0; zl < ZC; ++zl) {
        if (zl < nrow) {
          const float4 f = gy_s[(zl * NT + c) * 2], q = gy_s[(zl * NT + c) * 2 + 1];
          const float am = fmaxf(a + cdz[zl][0], 0.f);
          const float at = fmaxf(a + cdz[zl][1], 0.f);
          const float ap = fmaxf(a + cdz[zl][2], 0.f);
          const float pt = w0 * f.x + w1 * f.y + w2 * f.z + w3 * f.w;
          const float pq = w0 * q.x + w1 * q.y + w2 * q.z + w3 * q.w;
          const float dm = am > 0.f ? -pq : 0.f;
          const float dt = at > 0.f ? pt : 0.f;
          const float dp = ap > 0.f ? pq : 0.f;
          dcd[zl][0] += dm;
          dcd[zl][1] += dt;
          dcd[zl][2] += dp;
          dab += dt + (dm + dp);  // dm + dp: the -+ g/(2dt) legs cancel exactly
          const float dif = ap - am;
          dw[0] += at * f.x + dif * q.x;
          dw[1] += at * f.y + dif * q.y;
          dw[2] += at * f.z + dif * q.z;
          dw[3] += at * f.w + dif * q.w;
        }
      }
      dab_part[((size_t)blockIdx.z * H + h) * plane + cell] = dab;
    }
    const size_t psub = (size_t)tile * nsub + sub, np = (size_t)ntiles * nsub;
#pragma unroll
    for (int zl = 0; zl < ZC; ++zl) {
      if (zl < nrow) {
#pragma unroll
        for (int s = 0; s < 3; ++s)
          dcd_part[(((size_t)(z0 + zl)) * np + psub) * H * 3 + h * 3 + s] = dcd[zl][s];
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) dw2_part[(((size_t)blk * nsub + sub) * 4 + o) * H + h] = dw[o];
  }
}

}  // namespace

extern "C" int pat_mega_bwd(const float* ab, const float* cd, const float* w2t, const float* b2,
                            float* tile_parts, float* gbuf, float* fbuf, float* dab_part,
                            float* dcd_part,
                            float* dw2_part, float* db2_part, float* dab, float* dcd, float* dw2t,
                            float* db2, int nx, int ny, int nz, int H, int nsub, int periodic,
                            int upwind, float inv2dt, float inv2hx, float inv2hy, float inv2hz,
                            float scale_sigma, float scale_u, void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  cudaStream_t s = (cudaStream_t)stream;
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nzr = (nz + ZC - 1) / ZC;
  const dim3 grid(ntx, nty, nzr);
  cudaError_t err;

  const size_t smem1 = mega_smem_bytes(H, ZC);
  cudaFuncSetAttribute(k_mega<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  k_mega<true><<<grid, NT, smem1, s>>>(ab, cd, w2t, b2, tile_parts, gbuf, fbuf, nx, ny, nz, H,
                                       ZC, periodic, k, scale_sigma, scale_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  cudaFuncSetAttribute(k_mega_adjoint, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ADJOINT_SMEM);
  k_mega_adjoint<<<grid, NT, ADJOINT_SMEM, s>>>(ab, cd, w2t, fbuf, gbuf, dab_part, dcd_part,
                                                dw2_part, db2_part, nx, ny, nz, H, nsub, periodic,
                                                k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)launch_bwd_sums<3>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2,
                                 nx * ny, nz, H, nzr, ntx * nty, nsub, s);
}
