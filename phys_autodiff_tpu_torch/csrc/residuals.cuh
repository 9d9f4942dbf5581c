// K1's kernel body, shared by residuals.cu (K1) and mega_ngp.cu (K5's
// residual pass, which takes the scaled cotangents and the loss partials
// from one launch). See residuals.cu for the design.
#pragma once

#include "stencil.cuh"

namespace {

constexpr int TX = pat::TILE_X, TY = pat::TILE_Y, NT = pat::TILE_THREADS;
// MODE_SCALED_PARTIALS writes g = (2w/N) R and the loss partials.
constexpr int MODE_RESIDUALS = 0, MODE_SCALED = 1, MODE_PARTIALS = 2, MODE_SCALED_PARTIALS = 3;

// The 12 field channels in PACKED_ORDER:
// sigma_tm1, sigma_t, sigma_tp1, u_tm1[0..2], u_t[0..2], u_tp1[0..2].
struct FieldPtrs {
  const float* p[12];
};
struct OutPtrs {
  float* p[4];
};

template <int MODE>
__global__ void __launch_bounds__(NT)
    k_residuals(FieldPtrs f, OutPtrs o, float* __restrict__ tile_parts, int nx, int ny, int nz,
                int periodic, pat::StencilConsts k, float scale_sigma, float scale_u) {
  __shared__ float red[2 * (NT / 32)];
  const int x = blockIdx.x * TX + (threadIdx.x % TX);
  const int y = blockIdx.y * TY + (threadIdx.x / TX);
  const int z = blockIdx.z;
  const bool valid = x < nx && y < ny;
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    const size_t plane = (size_t)nx * ny;
    const size_t zo = (size_t)z * plane, row = zo + (size_t)y * nx;
    const size_t c = row + x;
    const size_t xm = row + pat::nbr_index(x - 1, nx, periodic);
    const size_t xp = row + pat::nbr_index(x + 1, nx, periodic);
    const size_t ym = zo + (size_t)pat::nbr_index(y - 1, ny, periodic) * nx + x;
    const size_t yp = zo + (size_t)pat::nbr_index(y + 1, ny, periodic) * nx + x;
    const size_t zm = (size_t)pat::nbr_index(z - 1, nz, periodic) * plane + (size_t)y * nx + x;
    const size_t zp = (size_t)pat::nbr_index(z + 1, nz, periodic) * plane + (size_t)y * nx + x;
    auto nbr = [&](const float* q) {
      return pat::Nbr{__ldg(q + c),  __ldg(q + xm), __ldg(q + xp), __ldg(q + ym),
                      __ldg(q + yp), __ldg(q + zm), __ldg(q + zp)};
    };
    const pat::Nbr s = nbr(f.p[1]), ux = nbr(f.p[6]), uy = nbr(f.p[7]), uz = nbr(f.p[8]);
    const float tm1[4] = {__ldg(f.p[0] + c), __ldg(f.p[3] + c), __ldg(f.p[4] + c),
                          __ldg(f.p[5] + c)};
    const float tp1[4] = {__ldg(f.p[2] + c), __ldg(f.p[9] + c), __ldg(f.p[10] + c),
                          __ldg(f.p[11] + c)};
    pat::cell_residual(k, s, ux, uy, uz, tm1, tp1, r);
    if (MODE == MODE_RESIDUALS) {
      o.p[0][c] = r[0];
      o.p[1][c] = r[1];
      o.p[2][c] = r[2];
      o.p[3][c] = r[3];
    } else if (MODE == MODE_SCALED || MODE == MODE_SCALED_PARTIALS) {
      o.p[0][c] = pat::mul(scale_sigma, r[0]);
      o.p[1][c] = pat::mul(scale_u, r[1]);
      o.p[2][c] = pat::mul(scale_u, r[2]);
      o.p[3][c] = pat::mul(scale_u, r[3]);
    }
  }
  if (MODE == MODE_PARTIALS || MODE == MODE_SCALED_PARTIALS) {
    float a = 0.f, b = 0.f;
    if (valid) pat::cell_squares(r, a, b);
    pat::block_sum2<NT>(a, b, red);
    if (threadIdx.x == 0) {
      const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
      tile_parts[(size_t)z * ntiles + tile] = a;
      tile_parts[((size_t)nz + z) * ntiles + tile] = b;
    }
  }
}

}  // namespace
