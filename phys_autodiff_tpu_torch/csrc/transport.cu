// K8: the semi-Lagrangian transport step, sm_90a.
//
// Replaces the three pallas_call constructors of
// phys_autodiff_tpu/pallas/transport.py: _build_transport_call (:70) and
// _build_transport_slab_call (:155), one step from sigma and u on two TPU
// pipelines (here one kernel, k_transport<C, false>), and
// _build_transport_pre_call (:315), the step from six precomputed weight
// planes (k_transport<1, true>).
//
// What it computes (apps/transport.transport_step, transport_step_many): C
// scalars f [C, nz, ny, nx] sharing one velocity u [3, nz, ny, nx],
//   d_a     = clamp(u_a * s_a, -1, 1),   s_a = f32(dt) / f32(h_a) (host)
//   lerp(f) = f + |d| * (nbr - f),       nbr = f[i-1] where d >= 0 (-0.0
//             included, as jnp.where), else f[i+1]; |d| is written as
//             d >= 0 ? d : -d, as the plain version writes it
//   out     = lerp_z(lerp_y(lerp_x(f))), each sweep on the previous
//             sweep's field, the offsets those of the cell itself.
// The precomputed-weights form (kernels/transport.transport_weights:
// p = max(d, 0), m = max(-d, 0) per axis) is
//   f + p * (f[i-1] - f) + m * (f[i+1] - f).
// Neighbours follow ops/stencil.shift: periodic wrap or edge clamp. Any
// nx, ny, nz >= 1 (nz = 1 and ragged tiles included; no lane gate).
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (stencil.cuh add / sub / mul, which nvcc never contracts into an FMA), in
// the plain version's order, so the kernel equals its plain version bitwise.
//
// Bound on this card: memory. Compulsory bytes a cell: 4 (C + 3) read and
// 4 C written (C = 1: 20 B; C = 3, the velocity self-advection: 24 B); the
// weights form 28 B read and 4 B written (32 B). About 10 FP32 operations a
// cell, sweep and channel. Design: a block owns a 32 x 8 (y, x) tile and
// walks ZC z planes plus one halo plane on each side. For each plane it
// x-sweeps its rows and the two halo rows into shared memory (x neighbours
// read from global memory, where L1 holds the row), y-sweeps its own cell
// from shared memory, and keeps the y-swept values of planes z-1, z and
// z+1 in registers, so the z sweep reads nothing again (the TPU kernel's
// rolling three-row window, in registers). Each input is read from DRAM
// about once; the halo rows (10/8) and halo planes ((ZC+2)/ZC) are
// re-reads that L2 serves. One __syncthreads a plane (double-buffered
// shared memory).

#include "stencil.cuh"

namespace {

using pat::add;
using pat::mul;
using pat::sub;

constexpr int TX = 32, TY = 8, NT = TX * TY, ZC = 8;

struct Weights {
  const float* p[6];  // xp, xm, yp, ym, zp, zm
};

__device__ __forceinline__ float offset(float u, float s) {
  return fminf(fmaxf(mul(u, s), -1.f), 1.f);
}

// |d| as the plain version writes it, d >= 0 ? d : -d (-0.0 stays -0.0).
__device__ __forceinline__ float sweep(float f, float fm, float fp, float d) {
  const bool right = d >= 0.f;
  return add(f, mul(right ? d : -d, sub(right ? fm : fp, f)));
}

__device__ __forceinline__ float sweep_pre(float f, float fm, float fp, float p, float m) {
  return add(add(f, mul(p, sub(fm, f))), mul(m, sub(fp, f)));
}

template <int C, bool PRE>
__global__ void __launch_bounds__(NT) k_transport(const float* __restrict__ f, const float* __restrict__ u,
                                                  Weights w, float* __restrict__ out, int nx, int ny, int nz,
                                                  int periodic, float sx, float sy, float sz) {
  __shared__ float a_s[2][C][TY + 2][TX];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x = (int)blockIdx.x * TX + tx, y = (int)blockIdx.y * TY + ty;
  const int z0 = (int)blockIdx.z * ZC, z1 = min(z0 + ZC, nz);
  const size_t plane = (size_t)nx * ny, n = plane * nz;
  // Every index is mapped into the grid (ragged threads compute values of
  // mapped cells that only the row y = ny, the clamp/wrap neighbour of the
  // last row, ever reads; nothing is written outside the grid).
  const int xc = pat::map_index(x, nx, periodic);
  const int xm = pat::nbr_index(xc - 1, nx, periodic), xp = pat::nbr_index(xc + 1, nx, periodic);
  const int yc = pat::map_index(y, ny, periodic);
  // Threads of tile rows 0 and 1 also x-sweep halo rows y0 - 1 and y0 + TY.
  const bool halo = ty < 2;
  const int yh = pat::map_index((int)blockIdx.y * TY + (ty == 0 ? -1 : TY), ny, periodic);
  const int rh = ty == 0 ? 0 : TY + 1;

  auto x_sweep = [&](size_t row, float* dst[C]) {
    if constexpr (PRE) {
      const float p = w.p[0][row + xc], m = w.p[1][row + xc];
      dst[0][0] = sweep_pre(f[row + xc], f[row + xm], f[row + xp], p, m);
    } else {
      const float d = offset(u[row + xc], sx);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* fc = f + c * n + row;
        dst[c][0] = sweep(fc[xc], fc[xm], fc[xp], d);
      }
    }
  };

  float bm[C] = {}, bc[C] = {}, bp[C] = {};
  int buf = 0;
  for (int k = 0; k < z1 - z0 + 2; ++k) {
    const int zp = pat::map_index(z0 - 1 + k, nz, periodic);
    const size_t zoff = (size_t)zp * plane;
    float* own[C];
    float* hal[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      own[c] = &a_s[buf][c][ty + 1][tx];
      hal[c] = &a_s[buf][c][rh][tx];
    }
    x_sweep(zoff + (size_t)yc * nx, own);
    if (halo) x_sweep(zoff + (size_t)yh * nx, hal);
    __syncthreads();
    const size_t cell = zoff + (size_t)yc * nx + xc;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = a_s[buf][c][ty + 1][tx], am = a_s[buf][c][ty][tx], ap = a_s[buf][c][ty + 2][tx];
      float b;
      if constexpr (PRE) {
        b = sweep_pre(a, am, ap, w.p[2][cell], w.p[3][cell]);
      } else {
        b = sweep(a, am, ap, offset(u[n + cell], sy));
      }
      bm[c] = bc[c];
      bc[c] = bp[c];
      bp[c] = b;
    }
    if (k >= 2 && x < nx && y < ny) {
      const size_t o = (size_t)(z0 + k - 2) * plane + (size_t)y * nx + x;
      if constexpr (PRE) {
        out[o] = sweep_pre(bc[0], bm[0], bp[0], w.p[4][o], w.p[5][o]);
      } else {
        const float d = offset(u[2 * n + o], sz);
#pragma unroll
        for (int c = 0; c < C; ++c) out[c * n + o] = sweep(bc[c], bm[c], bp[c], d);
      }
    }
    buf ^= 1;
  }
}

dim3 grid_of(int nx, int ny, int nz) { return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + ZC - 1) / ZC); }

}  // namespace

extern "C" {

// C channels f [C, nz, ny, nx] through u [3, nz, ny, nx] into out (same
// shape as f, not aliasing f or u); 1 <= C <= 4.
int pat_transport(const float* f, const float* u, float* out, int C, int nx, int ny, int nz, int periodic,
                  float sx, float sy, float sz, void* stream) {
  const dim3 grid = grid_of(nx, ny, nz);
  cudaStream_t s = (cudaStream_t)stream;
  const Weights none{};
  switch (C) {
    case 1: k_transport<1, false><<<grid, NT, 0, s>>>(f, u, none, out, nx, ny, nz, periodic, sx, sy, sz); break;
    case 2: k_transport<2, false><<<grid, NT, 0, s>>>(f, u, none, out, nx, ny, nz, periodic, sx, sy, sz); break;
    case 3: k_transport<3, false><<<grid, NT, 0, s>>>(f, u, none, out, nx, ny, nz, periodic, sx, sy, sz); break;
    case 4: k_transport<4, false><<<grid, NT, 0, s>>>(f, u, none, out, nx, ny, nz, periodic, sx, sy, sz); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// sigma [nz, ny, nx] and the six weight planes (xp, xm, yp, ym, zp, zm) into
// out (not aliasing any input).
int pat_transport_pre(const float* sigma, const float* xp, const float* xm, const float* yp, const float* ym,
                      const float* zp, const float* zm, float* out, int nx, int ny, int nz, int periodic,
                      void* stream) {
  const Weights w{{xp, xm, yp, ym, zp, zm}};
  k_transport<1, true><<<grid_of(nx, ny, nz), NT, 0, (cudaStream_t)stream>>>(sigma, nullptr, w, out, nx, ny, nz,
                                                                             periodic, 0.f, 0.f, 0.f);
  return (int)cudaGetLastError();
}

}  // extern "C"
