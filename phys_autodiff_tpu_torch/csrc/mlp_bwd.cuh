// The fixed-order sums that finish a coordinate-MLP table gradient, shared by
// K4 (mega_bwd.cu, S = 3 slices t-dt, t, t+dt) and K6 (fit.cu, S = 1 slice).
//
// Both kernels run the MLP backward h-major over the cells of a 32 x 8 tile
// and ZC z rows a block, and leave partials: dAB one per z range, dCD one per
// (tile, cell subset) and z row, dW2T one per (block, subset), db2 one per
// block. These passes add them in a fixed order, with no atomics, so the
// gradients are the same bits from run to run.

#pragma once

#include "stencil.cuh"

namespace {

// Fixed-order sums of the partials with many terms each, one output element
// per thread:
//   dAB [H, plane]   over the nzr z ranges
//   dCD [nz, H, S]   over the np = ntiles * nsub (tile, subset) pairs
template <int S>
__global__ void k_bwd_finalize(const float* __restrict__ dab_part,
                               const float* __restrict__ dcd_part, float* __restrict__ dab,
                               float* __restrict__ dcd, int plane, int nz, int H, int nzr, int np) {
  const size_t n_ab = (size_t)H * plane, n_cd = (size_t)nz * H * S;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_ab + n_cd;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < n_ab) {
      for (int r = 0; r < nzr; ++r) acc += dab_part[(size_t)r * n_ab + i];
      dab[i] = acc;
    } else {
      const size_t j = i - n_ab, z = j / (S * H), hs = j % (S * H);
      const float* src = dcd_part + z * np * S * H + hs;
#pragma unroll 8
      for (int p = 0; p < np; ++p) acc += src[(size_t)p * S * H];
      dcd[j] = acc;
    }
  }
}

// The few outputs with a partial per block, one output element per block:
// dW2T [4, H] over the nq = nblocks * nsub (block, subset) pairs, then db2
// [4] over the nblocks blocks. Each thread adds a strided share in order,
// then the block adds the shares in a fixed shuffle tree (deterministic).
__global__ void __launch_bounds__(pat::TILE_THREADS)
    k_bwd_reduce(const float* __restrict__ dw2_part, const float* __restrict__ db2_part,
                 float* __restrict__ dw2t, float* __restrict__ db2, int H, int nq, int nblk) {
  constexpr int RT = pat::TILE_THREADS;
  __shared__ float red[2 * (RT / 32)];
  const int j = blockIdx.x;
  float acc = 0.f, unused = 0.f;
  if (j < 4 * H) {
    for (int q = threadIdx.x; q < nq; q += RT) acc += dw2_part[(size_t)q * 4 * H + j];
  } else {
    for (int b = threadIdx.x; b < nblk; b += RT) acc += db2_part[(size_t)b * 4 + (j - 4 * H)];
  }
  pat::block_sum2<RT>(acc, unused, red);
  if (threadIdx.x == 0) {
    if (j < 4 * H) dw2t[j] = acc;
    else db2[j - 4 * H] = acc;
  }
}

// Launch both sums on stream s: dAB and dCD, then dW2T and db2.
template <int S>
cudaError_t launch_bwd_sums(const float* dab_part, const float* dcd_part, const float* dw2_part,
                            const float* db2_part, float* dab, float* dcd, float* dw2t, float* db2,
                            int plane, int nz, int H, int nzr, int ntiles, int nsub,
                            cudaStream_t s) {
  const size_t total = (size_t)H * plane + (size_t)nz * H * S;
  const int fin_blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  k_bwd_finalize<S><<<fin_blocks, 256, 0, s>>>(dab_part, dcd_part, dab, dcd, plane, nz, H, nzr,
                                               ntiles * nsub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nblk = ntiles * nzr;
  k_bwd_reduce<<<4 * H + 4, pat::TILE_THREADS, 0, s>>>(dw2_part, db2_part, dw2t, db2, H,
                                                       nblk * nsub, nblk);
  return cudaGetLastError();
}

}  // namespace
