// Shared device code of the residual kernels (K1 residuals.cu, K3 mega.cu).
//
// This is the CUDA counterpart of _slab_residuals
// (phys_autodiff_tpu/pallas/residuals.py), which the JAX package shares
// between its residual kernels and its mega-kernel: ONE residual body per
// cell, so both kernels compute bit-identical residuals.
//
// Rounding: the staged arm (ops/stencil.py) rounds after every add and
// multiply, and the fused-vs-staged tolerance class is 1e-7 relative. nvcc
// contracts a*b+c into an FMA by default, which rounds once and would break
// that class, so every operation here is an explicit round-to-nearest
// intrinsic (__fadd_rn / __fsub_rn / __fmul_rn, which nvcc never contracts),
// in the operation order of ops/stencil.py:
//   dt_sigma = (s_tp1 - s_tm1) * inv2dt
//   d_dx     = (f[x+1] - f[x-1]) * inv2hx          (same for y, z)
//   div_u    = (dux_dx + duy_dy) + duz_dz
//   adv(f)   = (ux * f_x + uy * f_y) + uz * f_z     (central or upwind f_*)
//   r_sigma  = (dt_sigma + adv_sigma) + s_t * div_u
//   r_u      = (u_tp1 - u_tm1) * inv2dt + adv(u)
#pragma once

#include <cuda_runtime.h>

namespace pat {

// The (x, y) tile of one block in K1 and K3: 32 x 8 cells, one thread per
// cell, x fastest. The host sizes the per-tile loss partials with the same
// numbers (kernels/residuals.py TILE_X, TILE_Y).
constexpr int TILE_X = 32, TILE_Y = 8, TILE_THREADS = TILE_X * TILE_Y;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// The host's float32 scale constants, 1/(2h) rounded exactly as
// ops.stencil.inv2h_f32 rounds them. The upwind 1/h is 2 * (1/(2h)), an
// exact power-of-two scaling of the same rounded value.
struct StencilConsts {
  float inv2dt, inv2hx, inv2hy, inv2hz;
  int upwind;
};

// One channel of the t slice at the centre cell and its six neighbours
// (neighbour indices already wrapped or clamped).
struct Nbr {
  float c, xm, xp, ym, yp, zm, zp;
};

// Neighbour index along an axis of extent n for i = centre +- 1:
// periodic wrap or edge clamp.
__device__ __forceinline__ int nbr_index(int i, int n, int periodic) {
  if (periodic) return i < 0 ? i + n : (i >= n ? i - n : i);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Any index (tile halos may lie more than one cell outside the grid).
__device__ __forceinline__ int map_index(int i, int n, int periodic) {
  if (periodic) return ((i % n) + n) % n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float central(float p, float m, float inv2h) {
  return mul(sub(p, m), inv2h);
}

// Strict upwind: backward difference where a > 0, forward at a <= 0.
__device__ __forceinline__ float upwind(float a, float c, float m, float p, float invh) {
  return a > 0.f ? mul(sub(c, m), invh) : mul(sub(p, c), invh);
}

__device__ __forceinline__ float advect(const StencilConsts& k, float ux, float uy, float uz,
                                        const Nbr& f) {
  float fx, fy, fz;
  if (k.upwind) {
    fx = upwind(ux, f.c, f.xm, f.xp, mul(2.f, k.inv2hx));
    fy = upwind(uy, f.c, f.ym, f.yp, mul(2.f, k.inv2hy));
    fz = upwind(uz, f.c, f.zm, f.zp, mul(2.f, k.inv2hz));
  } else {
    fx = central(f.xp, f.xm, k.inv2hx);
    fy = central(f.yp, f.ym, k.inv2hy);
    fz = central(f.zp, f.zm, k.inv2hz);
  }
  return add(add(mul(ux, fx), mul(uy, fy)), mul(uz, fz));
}

// Residuals of one cell: r = [R_sigma, R_ux, R_uy, R_uz], from the t-slice
// neighbours and dlt = t+dt minus t-dt of [sigma, ux, uy, uz] at the centre
// (sub(tp1, tm1): K3 keeps only that difference of the two slices).
__device__ __forceinline__ void cell_residual_dlt(const StencilConsts& k, const Nbr& s,
                                                  const Nbr& ux, const Nbr& uy, const Nbr& uz,
                                                  const float dlt[4], float r[4]) {
  const float div_u = add(add(central(ux.xp, ux.xm, k.inv2hx), central(uy.yp, uy.ym, k.inv2hy)),
                          central(uz.zp, uz.zm, k.inv2hz));
  const float dt_sigma = mul(dlt[0], k.inv2dt);
  r[0] = add(add(dt_sigma, advect(k, ux.c, uy.c, uz.c, s)), mul(s.c, div_u));
  r[1] = add(mul(dlt[1], k.inv2dt), advect(k, ux.c, uy.c, uz.c, ux));
  r[2] = add(mul(dlt[2], k.inv2dt), advect(k, ux.c, uy.c, uz.c, uy));
  r[3] = add(mul(dlt[3], k.inv2dt), advect(k, ux.c, uy.c, uz.c, uz));
}

// Residuals of one cell; tm1 / tp1: [sigma, ux, uy, uz] of the t-dt / t+dt
// slices at the centre.
__device__ __forceinline__ void cell_residual(const StencilConsts& k, const Nbr& s,
                                              const Nbr& ux, const Nbr& uy, const Nbr& uz,
                                              const float tm1[4], const float tp1[4],
                                              float r[4]) {
  const float dlt[4] = {sub(tp1[0], tm1[0]), sub(tp1[1], tm1[1]), sub(tp1[2], tm1[2]),
                        sub(tp1[3], tm1[3])};
  cell_residual_dlt(k, s, ux, uy, uz, dlt, r);
}

// The squared-residual contributions of one cell to the loss partials:
// (R_sigma^2, R_ux^2 + R_uy^2 + R_uz^2).
__device__ __forceinline__ void cell_squares(const float r[4], float& a, float& b) {
  a = mul(r[0], r[0]);
  b = add(add(mul(r[1], r[1]), mul(r[2], r[2])), mul(r[3], r[3]));
}

// Deterministic block sum of (a, b) over a block of NT threads (NT a
// multiple of 32, at most 1024): warp shuffles, then warp 0 adds the warp
// sums in warp order. The result is valid in thread 0. `red` is shared
// scratch of 2 * (NT / 32) floats; the caller syncs before reusing it.
// Its two stages apart, for a kernel that sums several rows with one
// barrier (K3): warp_sum2 leaves the warp's sums in lane 0, and after the
// barrier one warp adds NW warp sums (a[k], b[k] in warp order) with
// warps_sum2, the result again in lane 0; the same bits as block_sum2.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = add(a, __shfl_down_sync(0xffffffffu, a, off));
    b = add(b, __shfl_down_sync(0xffffffffu, b, off));
  }
}

template <int NW>
__device__ __forceinline__ void warps_sum2(const float* a_w, const float* b_w, float& a, float& b) {
  const int lane = threadIdx.x & 31;
  a = lane < NW ? a_w[lane] : 0.f;
  b = lane < NW ? b_w[lane] : 0.f;
  warp_sum2(a, b);
}

template <int NT>
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum2(a, b);
  if (lane == 0) {
    red[warp] = a;
    red[NT / 32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) warps_sum2<NT / 32>(red, red + NT / 32, a, b);
}

}  // namespace pat
