// The hand-derived adjoint of the transport stencil, shared by the backward
// mega-kernels K4 (mega_bwd.cu) and K5 (mega_ngp.cu).
//
// From the t-slice fields F = [sigma, ux, uy, uz] and the scaled residual
// cotangents G = (2w/N) R of every cell, each [4, nz, ny, nx], it gives the
// cotangents of the t-slice fields at one cell in gather form (the cell
// reads its six neighbours; nothing is scattered), for central or upwind
// differences, periodic or clamp boundaries, ragged grids and nz = 1
// (derivation at phys_autodiff_tpu/pallas/mega_bwd.py:34-60). The
// cotangents of the t -+ dt slices are -+ G / (2 dt) at the cell itself.
//
// The clamp z edge at nz = 1: the forward z difference is identically 0
// there, so its adjoint is 0. The gather form gives exactly that; the TPU
// kernels' edge legs do not (ROADMAP.md Queue C, R4 and R5).
#pragma once

#include "stencil.cuh"

namespace pat {

// One quantity at the centre cell and its neighbours along x, y, z
// (neighbour indices wrapped or clamped): m[a] at -1 and p[a] at +1 along a.
struct Q {
  float c, m[3], p[3];
};

__device__ __forceinline__ Q make_q(const Nbr& n) {
  return Q{n.c, {n.xm, n.ym, n.zm}, {n.xp, n.yp, n.zp}};
}

// Transpose of the central difference along one axis, gathered at the
// centre j for V given at j-1 (vm), j (vc), j+1 (vp): (V[j-1] - V[j+1]) / 2h
// over the neighbours that exist (hm, hp; always, when periodic), plus the
// clamp edge terms (the clamped difference at row 0 reads row 0 as its j-1
// neighbour, and at row n-1 reads row n-1 as its j+1 neighbour).
__device__ __forceinline__ float dtrans(float vc, float vm, float vp, bool hm, bool hp,
                                        float inv2h) {
  float s = (hm ? vm : 0.f) - (hp ? vp : 0.f);
  if (!hm) s -= vc;
  if (!hp) s += vc;
  return s * inv2h;
}

// Transpose of the upwind difference along one axis, gathered at the centre
// j, for weights w = u * G, where the advecting velocity u picks each row's
// branch: backward (c[i] - c[i-1]) where u > 0, forward (c[i+1] - c[i])
// otherwise. With wb = [u > 0] w and wf = w - wb:
//   (wb[j] - wf[j] - wb[j+1] + wf[j-1]) / h,
// dropping rows outside the grid and the clamp edge rows' degenerate
// branches (backward at row 0, forward at row n-1).
__device__ __forceinline__ float utrans(float wc, float wm, float wp, float uc, float um, float up,
                                        bool hm, bool hp, float invh) {
  const float wbc = hm && uc > 0.f ? wc : 0.f;
  const float wfc = hp && !(uc > 0.f) ? wc : 0.f;
  const float wbp = hp && up > 0.f ? wp : 0.f;
  const float wfm = hm && !(um > 0.f) ? wm : 0.f;
  return (wbc - wfc - wbp + wfm) * invh;
}

// Cotangents of the t-slice fields at one cell, d = [d sigma, d ux, d uy,
// d uz], from the fields F and the residual cotangents G at the cell and
// its neighbours:
//   d sigma = sum_b T_b(u_b g_sigma) + g_sigma div(u)
//   d u_a   = g_sigma A_a(sigma) + sum_c g_uc A_a(u_c)
//             + D_a^T(sigma g_sigma) + sum_b T_b(u_b g_ua)
// A_a is the advection difference along a (central, or upwind selected by
// u_a at the cell), T_b its transpose; sigma div(u) stays central.
__device__ __forceinline__ void cell_adjoint(const StencilConsts& k, const Q F[4], const Q G[4],
                                             const bool hm[3], const bool hp[3], float d[4]) {
  const float inv2h[3] = {k.inv2hx, k.inv2hy, k.inv2hz};
  const float invh[3] = {2.f * k.inv2hx, 2.f * k.inv2hy, 2.f * k.inv2hz};
  auto adv = [&](const Q& f, int a) {
    if (k.upwind)
      return F[1 + a].c > 0.f ? (f.c - f.m[a]) * invh[a] : (f.p[a] - f.c) * invh[a];
    return (f.p[a] - f.m[a]) * inv2h[a];
  };
  auto trans = [&](const Q& g, int b) {
    const Q& u = F[1 + b];
    const float vc = u.c * g.c, vm = u.m[b] * g.m[b], vp = u.p[b] * g.p[b];
    if (k.upwind) return utrans(vc, vm, vp, u.c, u.m[b], u.p[b], hm[b], hp[b], invh[b]);
    return dtrans(vc, vm, vp, hm[b], hp[b], inv2h[b]);
  };
  const Q& s = F[0];
  const Q& gs = G[0];
  const float div_u = ((F[1].p[0] - F[1].m[0]) * inv2h[0] + (F[2].p[1] - F[2].m[1]) * inv2h[1]) +
                      (F[3].p[2] - F[3].m[2]) * inv2h[2];
  d[0] = trans(gs, 0) + trans(gs, 1) + trans(gs, 2) + gs.c * div_u;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float v = gs.c * adv(s, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) v += G[1 + c].c * adv(F[1 + c], a);
    v += dtrans(s.c * gs.c, s.m[a] * gs.m[a], s.p[a] * gs.p[a], hm[a], hp[a], inv2h[a]);
#pragma unroll
    for (int b = 0; b < 3; ++b) v += trans(G[1 + a], b);
    d[1 + a] = v;
  }
}

// The t-slice field cotangents d [4] of cell (x, y, z), and the residual
// cotangents gc [4] at the cell, from the t-slice fields f and the scaled
// residual cotangents g, both [4, nz, ny, nx], read through L1 / L2.
__device__ __forceinline__ void t_slice_adjoint(const float* __restrict__ f,
                                                const float* __restrict__ g, int x, int y, int z,
                                                int nx, int ny, int nz, int periodic,
                                                const StencilConsts& k, float d[4], float gc[4]) {
  const int plane = nx * ny;
  const size_t ncell = (size_t)nz * plane;
  const int own = y * nx + x;
  const int xm = y * nx + nbr_index(x - 1, nx, periodic);
  const int xp = y * nx + nbr_index(x + 1, nx, periodic);
  const int ym = nbr_index(y - 1, ny, periodic) * nx + x;
  const int yp = nbr_index(y + 1, ny, periodic) * nx + x;
  const size_t zo = (size_t)z * plane;
  const size_t zmo = (size_t)nbr_index(z - 1, nz, periodic) * plane;
  const size_t zpo = (size_t)nbr_index(z + 1, nz, periodic) * plane;
  auto around = [&](const float* q) {
    return make_q(Nbr{__ldg(q + zo + own), __ldg(q + zo + xm), __ldg(q + zo + xp),
                      __ldg(q + zo + ym), __ldg(q + zo + yp), __ldg(q + zmo + own),
                      __ldg(q + zpo + own)});
  };
  Q F[4], G[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    F[c] = around(f + c * ncell);
    G[c] = around(g + c * ncell);
    gc[c] = G[c].c;
  }
  // the j-1 / j+1 neighbour exists along x, y, z (always, when periodic)
  const bool hm[3] = {periodic || x > 0, periodic || y > 0, periodic || z > 0};
  const bool hp[3] = {periodic || x < nx - 1, periodic || y < ny - 1, periodic || z < nz - 1};
  cell_adjoint(k, F, G, hm, hp, d);
}

}  // namespace pat
