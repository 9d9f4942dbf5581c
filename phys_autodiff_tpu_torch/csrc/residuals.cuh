// K1's kernel body, shared by residuals.cu (K1) and mega_ngp.cu (K5's
// residual pass, which takes the scaled cotangents and the loss partials
// from one launch). See residuals.cu for the design. The element types of
// the fields (Tin) and of the outputs (Tout) are template arguments: float,
// or __nv_bfloat16 for K1's bf16-I/O entry points; the arithmetic is float
// in every instantiation, and the float one is the f32 kernel as it was.
#pragma once

#include <cuda_bf16.h>

#include "stencil.cuh"

namespace {

constexpr int TX = pat::TILE_X, TY = pat::TILE_Y, NT = pat::TILE_THREADS;
// MODE_SCALED_PARTIALS writes g = (2w/N) R and the loss partials.
constexpr int MODE_RESIDUALS = 0, MODE_SCALED = 1, MODE_PARTIALS = 2, MODE_SCALED_PARTIALS = 3;

// The 12 field channels in PACKED_ORDER:
// sigma_tm1, sigma_t, sigma_tp1, u_tm1[0..2], u_t[0..2], u_tp1[0..2].
template <class T>
struct FieldPtrsT {
  const T* p[12];
};
template <class T>
struct OutPtrsT {
  T* p[4];
};
using FieldPtrs = FieldPtrsT<float>;
using OutPtrs = OutPtrsT<float>;

// A field value as float, and a float stored in the output's type (bf16
// rounds to nearest even).
__device__ __forceinline__ float ld_field(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ld_field(const __nv_bfloat16* q) { return __bfloat162float(__ldg(q)); }
__device__ __forceinline__ void st_out(float* q, float v) { *q = v; }
__device__ __forceinline__ void st_out(__nv_bfloat16* q, float v) { *q = __float2bfloat16_rn(v); }

template <int MODE, class Tin = float, class Tout = float>
__global__ void __launch_bounds__(NT)
    k_residuals(FieldPtrsT<Tin> f, OutPtrsT<Tout> o, float* __restrict__ tile_parts, int nx, int ny, int nz,
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
    auto nbr = [&](const Tin* q) {
      return pat::Nbr{ld_field(q + c),  ld_field(q + xm), ld_field(q + xp), ld_field(q + ym),
                      ld_field(q + yp), ld_field(q + zm), ld_field(q + zp)};
    };
    const pat::Nbr s = nbr(f.p[1]), ux = nbr(f.p[6]), uy = nbr(f.p[7]), uz = nbr(f.p[8]);
    const float tm1[4] = {ld_field(f.p[0] + c), ld_field(f.p[3] + c), ld_field(f.p[4] + c),
                          ld_field(f.p[5] + c)};
    const float tp1[4] = {ld_field(f.p[2] + c), ld_field(f.p[9] + c), ld_field(f.p[10] + c),
                          ld_field(f.p[11] + c)};
    pat::cell_residual(k, s, ux, uy, uz, tm1, tp1, r);
    if (MODE == MODE_RESIDUALS) {
      st_out(o.p[0] + c, r[0]);
      st_out(o.p[1] + c, r[1]);
      st_out(o.p[2] + c, r[2]);
      st_out(o.p[3] + c, r[3]);
    } else if (MODE == MODE_SCALED || MODE == MODE_SCALED_PARTIALS) {
      st_out(o.p[0] + c, pat::mul(scale_sigma, r[0]));
      st_out(o.p[1] + c, pat::mul(scale_u, r[1]));
      st_out(o.p[2] + c, pat::mul(scale_u, r[2]));
      st_out(o.p[3] + c, pat::mul(scale_u, r[3]));
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
