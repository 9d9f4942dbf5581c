// K8: the semi-Lagrangian transport step, sm_90a.
//
// Replaces the three pallas_call constructors of
// phys_autodiff_tpu/pallas/transport.py: _build_transport_call (:70) and
// _build_transport_slab_call (:155), one step from sigma and u on two TPU
// pipelines (here one kernel, k_transport<C, 1>, and k_transport<3, 0> for
// u advecting itself), and _build_transport_pre_call (:315), the step from
// six precomputed weight planes (k_transport<1, 2>, the same walk).
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
// The slab form (pat_transport_slab, the z-sharded step of
// apps/transport.py, whose JAX counterpart runs in XLA): f and u hold a
// rank's nz_local planes with one halo plane a side, and the walk writes
// only the owned planes (walk_of's output window). The halo planes are real
// planes, so z needs no wrap or clamp there; their x and y sweeps are their
// owner's, so each owned plane is bitwise the whole-grid step's.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (stencil.cuh add / sub / mul, which nvcc never contracts into an FMA), in
// the plain version's order, so the kernel equals its plain version bitwise.
//
// Bound on this card: memory. Compulsory bytes a cell: 4 (C + 3) read and
// 4 C written (C = 1: 20 B; the velocity self-advection, C = 3 through u
// itself: 24 B); the weights form 28 B read and 4 B written (32 B). About
// 10 FP32 operations a cell, sweep and channel. At 128x96x96 the inputs
// (24 MB at C = 1) stay in the 50 MB L2 from call to call, so what bounds
// the kernel there is latency and L2 traffic: a block that loads a plane
// only when it needs it waits one dependent load round a plane, and halos
// are re-read. At 256^3 (335 MB) it is DRAM.
//
// Design: a block owns a 32 x 8 (x, y) tile and walks a z chunk of zc
// planes plus one halo plane on each side. The host chooses zc so that the
// blocks fill the card in balanced waves (kernels/transport.py
// launch_geometry: 528 blocks of 9 planes at 128x96x96, 512 of 128 at
// 256^3); the grid is tiles x z chunks, tile fastest, so the blocks that
// run together are neighbours at the same z, and L2 serves the halo rows
// and columns that one block reads of the next.
//   - Loads in flight: each plane's tile with its y halo rows and x halo
//     columns lands in a ring of STAGES slots in shared memory by cp.async
//     (16 bytes where nx % 4 == 0 and the 4 columns lie in the grid, else
//     4; the slot's rows dealt evenly to the warps), STAGES - 1 planes
//     ahead of the plane being swept: a block waits on one load round at
//     its start, not on one a plane. One __syncthreads a plane: after it
//     every thread has finished the slot that is refilled next.
//   - Equal work: every thread sweeps its own cell from the ring, the x
//     sweeps of rows y - 1, y and y + 1 (recomputed by each thread: no warp
//     does a halo row's extra work, and no second barrier), the y sweep,
//     and the z sweep from the y-swept values of planes z - 1, z and z + 1
//     in registers (the TPU kernel's rolling three-row window); the z
//     offset of plane z is read while it is swept and kept for the next
//     step, which outputs it.
//   - The self-advection (the fields are u itself, C = 3) reads its
//     offsets from the fields' own slot rows, so u is copied once, not
//     twice (k_transport<3, 0>).

#include <cstdint>

#include "stencil.cuh"

namespace {

using pat::add;
using pat::mul;
using pat::sub;

constexpr int TX = 32, TY = 8, NT = TX * TY;
constexpr int STAGES = 3;         // ring slots: STAGES - 1 planes in flight
constexpr int BLOCKS_PER_SM = 4;  // kernels/transport.py BLOCKS_PER_SM
constexpr int XO = 4;             // f's first tile column in a slot row (16-byte aligned)
constexpr int FX = TX + 2 * XO;   // f's slot row: halo x0 - 1 at XO - 1, x0 + TX at XO + TX

// One ring slot: the C scalars with their x and y halos, and NW arrays of
// each axis' offsets (u_a: NW = 1; the weights form's p and m: NW = 2; the
// self-advection, where the C = 3 scalars are u itself: NW = 0, the
// offsets read from f).
template <int C, int NW>
struct Slot {
  float f[C][TY + 2][FX];
  float wx[NW][TY + 2][TX];
  float wy[NW][TY][TX];
  float wz[NW][TY][TX];
};

template <int C>
struct Slot<C, 0> {
  float f[C][TY + 2][FX];
};

// The input planes: f's first channel (channel c at c * n) and, per axis,
// u_a or the weights form's (p, m).
struct Inputs {
  const float* f;
  const float* w[3][2];
};

// The asynchronous copies: cp.async into shared memory, one commit group a
// plane, and the wait for all but the newest N groups of the thread.
__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void async_copy16(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// A cell's offset along one axis (NW = 0, 1: d = clamp(u_a s_a, -1, 1)) or
// its weights (NW = 2: p, m), read from its axis' NW arrays in a slot (for
// NW = 0 from u_a's channel of f).
template <int NW>
struct Off {
  float a, b;
};

template <int NW>
__device__ __forceinline__ Off<NW> load_off(const float* w, int stride, float s) {
  if constexpr (NW == 2) {
    return {w[0], w[stride]};
  } else {
    return {offset(w[0], s), 0.f};
  }
}

template <int NW>
__device__ __forceinline__ float sweep_o(float f, float fm, float fp, Off<NW> o) {
  if constexpr (NW == 2) {
    return sweep_pre(f, fm, fp, o.a, o.b);
  } else {
    return sweep(f, fm, fp, o.a);
  }
}

// One of an axis' NW arrays, without indexing the kernel's parameters by a
// register.
template <int NW>
__device__ __forceinline__ const float* pick(const float* const (&w)[2], int a) {
  return NW == 1 || a == 0 ? w[0] : w[1];
}

// The block's part of the walk (kernels/transport.py block_walks).
struct Walk {
  int x0, y0, z0, z1;
};

// The walk covers the output planes [zoff, zoff + nzo) of the input's nz:
// the whole grid (zoff = 0, nzo = nz) or a slab's owned planes between its
// two halo planes (zoff = 1, nzo = nz - 2).
__device__ __forceinline__ Walk walk_of(int nx, int ny, int nzo, int zoff, int zc) {
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY);
  const int tile = (int)blockIdx.x % ntiles, chunk = (int)blockIdx.x / ntiles;
  const int z0 = chunk * zc;
  return {tile % ntx * TX, tile / ntx * TY, zoff + z0, zoff + min(z0 + zc, nzo)};
}

// An index along an axis of extent n: i itself inside the grid, else its
// wrap or clamp image.
__device__ __forceinline__ int into(int i, int n, int periodic) {
  return i >= 0 && i < n ? i : pat::map_index(i, n, periodic);
}

// The rows of a slot in order: f's C (TY + 2), then wx's NW (TY + 2), wy's
// NW TY and wz's NW TY, which lie one after another in the slot. For each,
// made once a block: its source row (array and mapped y; the plane is
// added a step) and its offset in the slot. wz's rows (from Z0 on) are
// copied only for the planes that are output, not for the two halo planes.
template <int C, int NW>
struct Rows {
  static constexpr int F = C * (TY + 2), Z0 = F + NW * (TY + 2) + NW * TY, ALL = Z0 + NW * TY;
  static constexpr int WX = C * (TY + 2) * FX;  // wx's offset in a slot
  const float* src[ALL];
  int dst[ALL];
};

template <int C, int NW>
__device__ __forceinline__ void make_rows(Rows<C, NW>& t, const Inputs& in, const Walk& w, int nx, int ny, int nz,
                                          int periodic) {
  using R = Rows<C, NW>;
  const size_t n = (size_t)nx * ny * nz;
  for (int r = threadIdx.x; r < R::ALL; r += NT) {
    const float* src;
    int y;
    if (r < R::F) {
      src = in.f + r / (TY + 2) * n;
      y = w.y0 - 1 + r % (TY + 2);
      t.dst[r] = r * FX + XO;
    } else {
      const int q = r - R::F;
      if (q < NW * (TY + 2)) {
        src = pick<NW>(in.w[0], q / (TY + 2));
        y = w.y0 - 1 + q % (TY + 2);
      } else {
        const int q2 = q - NW * (TY + 2), axis = q2 < NW * TY ? 1 : 2, q3 = q2 % (NW * TY);
        src = axis == 1 ? pick<NW>(in.w[1], q3 / TY) : pick<NW>(in.w[2], q3 / TY);
        y = w.y0 + q3 % TY;
      }
      t.dst[r] = R::WX + q * TX;
    }
    t.src[r] = src + (size_t)into(y, ny, periodic) * nx;
  }
}

// What a thread copies of every plane, fixed for the walk. The slot's rows
// are dealt to the warps: with 16-byte copies four rows a warp (eight lanes
// a row, four columns a lane), else a row a warp (a column a lane; x the
// mapped column). The first 2 F threads also copy one of f's halo columns.
struct Lane {
  int row0, step, col, x, hdst;
  const float* hsrc;
};

template <int C, int NW>
__device__ __forceinline__ Lane lane_of(const Inputs& in, const Walk& w, int nx, int ny, int nz, int periodic,
                                        bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Lane l;
  l.row0 = vec ? warp * 4 + (lane >> 3) : warp;
  l.step = vec ? NT / 8 : NT / 32;
  l.col = vec ? 4 * (lane & 7) : lane;
  l.x = vec ? w.x0 + l.col : into(w.x0 + lane, nx, periodic);
  l.hdst = -1;
  l.hsrc = nullptr;
  if (threadIdx.x < 2 * Rows<C, NW>::F) {
    const int r = threadIdx.x >> 1, right = threadIdx.x & 1;
    const size_t n = (size_t)nx * ny * nz;
    l.hdst = r * FX + (right ? XO + TX : XO - 1);
    l.hsrc = in.f + r / (TY + 2) * n + (size_t)into(w.y0 - 1 + r % (TY + 2), ny, periodic) * nx +
             into(right ? w.x0 + TX : w.x0 - 1, nx, periodic);
  }
  return l;
}

// Issue the copies of walk plane k into a slot: the plane z0 - 1 + k
// (zread, mapped into the grid); wz's rows only for an output plane
// (with_z).
template <int C, int NW>
__device__ __forceinline__ void issue_plane(float* slot, const Rows<C, NW>& t, const Lane& l, size_t zread,
                                            bool with_z, bool vec, int nx, int periodic) {
  using R = Rows<C, NW>;
  const int rows = with_z ? R::ALL : R::Z0;
  for (int r = l.row0; r < rows; r += l.step) {
    const float* src = t.src[r] + zread;
    float* dst = slot + t.dst[r] + l.col;
    if (!vec) {
      async_copy4(dst, src + l.x);
    } else if (l.x + 3 < nx) {
      async_copy16(dst, src + l.x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) async_copy4(dst + j, src + into(l.x + j, nx, periodic));
    }
  }
  if (l.hsrc) async_copy4(slot + l.hdst, l.hsrc + zread);
}

// C channels through one velocity (NW = 1), the three components of u
// through u itself (C = 3, NW = 0) or the one channel of the weights form
// (C = 1, NW = 2). The inputs hold nz planes; the output holds the nzo
// planes from input plane zoff on (walk_of). zc: the planes of a z chunk
// (the host's launch geometry); vec: 16-byte copies allowed (nx % 4 == 0
// and every input 16-byte aligned).
template <int C, int NW>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) k_transport(Inputs in, float* __restrict__ out, int nx, int ny,
                                                                 int nz, int nzo, int zoff, int periodic, int zc,
                                                                 int vec, float sx, float sy, float sz) {
  __shared__ __align__(16) Slot<C, NW> ring[STAGES];
  __shared__ Rows<C, NW> rows;
  const Walk w = walk_of(nx, ny, nzo, zoff, zc);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x = w.x0 + tx, y = w.y0 + ty;
  const size_t plane = (size_t)nx * ny, n = plane * nzo;
  const bool own = x < nx && y < ny;
  const int walk = w.z1 - w.z0 + 2;
  make_rows(rows, in, w, nx, ny, nz, periodic);
  const Lane l = lane_of<C, NW>(in, w, nx, ny, nz, periodic, vec != 0);
  __syncthreads();  // the row table
  auto issue = [&](int k) {
    issue_plane(reinterpret_cast<float*>(&ring[k % STAGES]), rows, l, (size_t)into(w.z0 - 1 + k, nz, periodic) * plane,
                k >= 1 && k <= walk - 2, vec != 0, nx, periodic);
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < walk) issue(k);
    async_commit();
  }
  float bm[C] = {}, bc[C] = {}, bp[C] = {};
  Off<NW> oz = {};  // the z offset of the plane before, which this step outputs
  for (int k = 0; k < walk; ++k) {
    // Plane k has landed (the newest STAGES - 2 groups may still be in
    // flight); after the barrier every thread also finished plane k - 1,
    // whose slot the next issue refills.
    async_wait<STAGES - 2>();
    __syncthreads();  // plane k landed
    if (k + STAGES - 1 < walk) issue(k + STAGES - 1);
    async_commit();
    const Slot<C, NW>& s = ring[k % STAGES];
    // The x offsets of rows y - 1, y, y + 1 (slot rows ty .. ty + 2) and the
    // cell's y offset; then, per channel, the x sweeps of the three rows and
    // the y sweep of the cell.
    Off<NW> ox[3], oy;
    if constexpr (NW == 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) ox[r] = load_off<NW>(&s.f[0][ty + r][XO + tx], 0, sx);
      oy = load_off<NW>(&s.f[1][ty + 1][XO + tx], 0, sy);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) ox[r] = load_off<NW>(&s.wx[0][ty + r][tx], (TY + 2) * TX, sx);
      oy = load_off<NW>(&s.wy[0][ty][tx], TY * TX, sy);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float a[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* fr = &s.f[c][ty + r][XO + tx];
        a[r] = sweep_o(fr[0], fr[-1], fr[1], ox[r]);
      }
      bm[c] = bc[c];
      bc[c] = bp[c];
      bp[c] = sweep_o(a[1], a[0], a[2], oy);
    }
    if (k >= 2 && own) {
      const size_t o = (size_t)(w.z0 + k - 2 - zoff) * plane + (size_t)y * nx + x;
#pragma unroll
      for (int c = 0; c < C; ++c) out[c * n + o] = sweep_o(bc[c], bm[c], bp[c], oz);
    }
    if (k >= 1 && k <= walk - 2) {
      if constexpr (NW == 0) {
        oz = load_off<NW>(&s.f[2][ty + 1][XO + tx], 0, sz);
      } else {
        oz = load_off<NW>(&s.wz[0][ty][tx], TY * TX, sz);
      }
    }
  }
}

template <int C, int NW>
int launch(const Inputs& in, float* out, int nx, int ny, int nz, int nzo, int zoff, int periodic, int zc, float sx,
           float sy, float sz, cudaStream_t stream) {
  if (zc < 1 || nzo < 1) return (int)cudaErrorInvalidValue;
  uintptr_t bits = (uintptr_t)in.f;
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < NW; ++j) bits |= (uintptr_t)in.w[a][j];
  const int vec = nx % 4 == 0 && bits % 16 == 0;
  const int blocks = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * ((nzo + zc - 1) / zc);
  k_transport<C, NW><<<blocks, NT, 0, stream>>>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, vec, sx, sy, sz);
  return (int)cudaGetLastError();
}

// C channels of input planes nz (u's three at stride nx ny nz) into the nzo
// output planes from zoff on; 1 <= C <= 4, the self-advection when C == 3
// and f == u.
int channels(const float* f, const float* u, float* out, int C, int nx, int ny, int nz, int nzo, int zoff,
             int periodic, int zc, float sx, float sy, float sz, cudaStream_t s) {
  const size_t n = (size_t)nx * ny * nz;
  const Inputs in{f, {{u, nullptr}, {u + n, nullptr}, {u + 2 * n, nullptr}}};
  if (C == 3 && f == u) return launch<3, 0>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, sx, sy, sz, s);
  switch (C) {
    case 1: return launch<1, 1>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, sx, sy, sz, s);
    case 2: return launch<2, 1>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, sx, sy, sz, s);
    case 3: return launch<3, 1>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, sx, sy, sz, s);
    case 4: return launch<4, 1>(in, out, nx, ny, nz, nzo, zoff, periodic, zc, sx, sy, sz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C channels f [C, nz, ny, nx] through u [3, nz, ny, nx] into out (same
// shape as f, not aliasing f or u); 1 <= C <= 4. zc: the z chunk of the
// launch geometry (kernels/transport.launch_geometry).
int pat_transport(const float* f, const float* u, float* out, int C, int nx, int ny, int nz, int periodic, int zc,
                  float sx, float sy, float sz, void* stream) {
  return channels(f, u, out, C, nx, ny, nz, nz, 0, periodic, zc, sx, sy, sz, (cudaStream_t)stream);
}

// The slab form: f [C, nz_local + 2, ny, nx] and u [3, nz_local + 2, ny, nx],
// each a rank's nz_local planes with one halo plane a side (the neighbours'
// planes, or on a clamped grid's edge a copy of the edge plane), into out
// [C, nz_local, ny, nx], the owned planes only. The z sweep reads the halo
// planes as they are (no wrap or clamp in z); x and y keep the grid's. The
// halo planes take their own x and y sweeps from their own u rows, the same
// arithmetic as their owner's, so each owned plane is bitwise the whole-grid
// step's. zc: the launch geometry of nz_local.
int pat_transport_slab(const float* f, const float* u, float* out, int C, int nx, int ny, int nz_local, int periodic,
                       int zc, float sx, float sy, float sz, void* stream) {
  return channels(f, u, out, C, nx, ny, nz_local + 2, nz_local, 1, periodic, zc, sx, sy, sz, (cudaStream_t)stream);
}

// sigma [nz, ny, nx] and the six weight planes (xp, xm, yp, ym, zp, zm) into
// out (not aliasing any input); zc as for pat_transport.
int pat_transport_pre(const float* sigma, const float* xp, const float* xm, const float* yp, const float* ym,
                      const float* zp, const float* zm, float* out, int nx, int ny, int nz, int periodic, int zc,
                      void* stream) {
  const Inputs in{sigma, {{xp, xm}, {yp, ym}, {zp, zm}}};
  return launch<1, 2>(in, out, nx, ny, nz, nz, 0, periodic, zc, 0.f, 0.f, 0.f, (cudaStream_t)stream);
}

}  // extern "C"
