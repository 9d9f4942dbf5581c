// The encoded-field head's backward pieces shared by K5 (mega_ngp.cu) and K7
// (fit_ngp.cu). A block owns a 32 x 8 (x, y) tile and walks z rows; for the
// row in hand, shared memory holds W1c [LF][H], the dW1c accumulators
// [LF][H], the row's encoding [LF][NT] and the hidden-unit cotangents
// dz1 [H][NT + 1] (a padded row: (h, cell) and (h + 1, cell) fall in other
// banks).

#pragma once

#include "stencil.cuh"

namespace {

constexpr int NGP_NT = pat::TILE_THREADS;
constexpr int NGP_DZ = NGP_NT + 1;

// B2, thread per cell: dEnc[c] = sum_h W1c[c, h] dz1[h, cell] for the
// thread's cell; denc_cell points at channel 0 of the cell in this row,
// channels `plane` apart.
__device__ __forceinline__ void ngp_denc_cell(float* __restrict__ denc_cell, size_t plane,
                                              const float* w1c_s, const float* dz_s, int LF,
                                              int H) {
  for (int c = 0; c < LF; ++c) {
    const float* wr = w1c_s + c * H;
    float acc = 0.f;
    for (int hh = 0; hh < H; ++hh) acc = fmaf(wr[hh], dz_s[hh * NGP_DZ + threadIdx.x], acc);
    denc_cell[c * plane] = acc;
  }
}

// B3, thread per (c, h): dW1c[c, h] += sum over the row's cells of
// enc[c, cell] dz1[h, cell], in shared memory.
__device__ __forceinline__ void ngp_dw1_row(float* dw1_s, const float* enc_s, const float* dz_s,
                                            int LF, int H) {
  for (int j = threadIdx.x; j < LF * H; j += NGP_NT) {
    const float* ep = enc_s + (j / H) * NGP_NT;
    const float* dp = dz_s + (j % H) * NGP_DZ;
    float acc = dw1_s[j];
    for (int cl = 0; cl < NGP_NT; ++cl) acc = fmaf(ep[cl], dp[cl], acc);
    dw1_s[j] = acc;
  }
}

// out[j] = sum over p of part[p, j], one output element per block: each
// thread adds a strided share in order, then the block adds the shares in
// a fixed shuffle tree (deterministic).
__global__ void __launch_bounds__(NGP_NT)
    k_sum_parts(const float* __restrict__ part, float* __restrict__ out, int nout, int nparts) {
  __shared__ float red[2 * (NGP_NT / 32)];
  const int j = blockIdx.x;
  float acc = 0.f, unused = 0.f;
  for (int p = threadIdx.x; p < nparts; p += NGP_NT) acc += part[(size_t)p * nout + j];
  pat::block_sum2<NGP_NT>(acc, unused, red);
  if (threadIdx.x == 0) out[j] = acc;
}

}  // namespace
