// K3's kernel body (mega.cu).
//
// K3 replaces _build_mega_call of phys_autodiff_tpu/pallas/mega.py (:316). The
// fields at t-dt, t, t+dt never reach device memory: the kernel evaluates
// the folded MLP (same AB / CD / W2T / b2 tables as K2) where the stencil
// needs a value, computes the residual through the shared body in
// stencil.cuh, and reduces R_sigma^2 and |R_u|^2 into per-(z plane, tile)
// partials that K1's finalize pass adds in a fixed order (no atomics).
//
// Bound on this card: FP32 instruction throughput in the MLP (about 6H operations per cell
// and slice; the compulsory DRAM traffic is only AB + CD + W2 and 8 B per
// tile and plane). Design:
//   * A block owns a 32 x 8 (x, y) tile and marches over a range of ZR z
//     rows. The stencil needs the t-slice fields of row z with a 1-cell x/y
//     halo, the t slice at (x, y, z +- 1), and t +- dt only at the centre
//     cell. So each thread evaluates its own column for all three slices
//     (one AB load feeds all three), keeps the t slice of rows z-1, z, z+1
//     and t +- dt of row z in registers, and publishes the t slice of row z
//     (own cell, plus 80 x/y halo cells computed by the first 80 threads,
//     t slice only) in a double-buffered shared window.
//   * The TPU kernel carries its window across the programs of a sequential
//     grid (mega.py:372-376). Blocks on this card run in no order, so a
//     carry exists only inside a block: a block recomputes the one row below
//     and the one row above its z range instead.
//   * AB ([H, ny, nx], 6.3 MB at H=128 on 128x96x96) is read through L2,
//     where it stays resident, not staged whole; the CD rows of the block's
//     z range and W2T sit in shared memory and are read as broadcasts.
// FMAs are allowed in the MLP (class MLP_INFER_REL); the residual body keeps
// the staged arm's per-operation rounding.

#pragma once

#include "stencil.cuh"

namespace {

constexpr int TX = pat::TILE_X, TY = pat::TILE_Y, NT = pat::TILE_THREADS;
constexpr int WX = TX + 2, WY = TY + 2, WN = WX * WY;  // window with x/y halo
constexpr int NHALO = 2 * TX + 2 * TY;

// y[s][o] for slices s in {t-dt, t, t+dt} (NS = 3) or the t slice alone
// (NS = 1) at plane cell `cell`; cd_row is CD[z] ([H, 3]).
template <int NS>
__device__ __forceinline__ void mlp_cell(const float* __restrict__ ab, int plane, int cell,
                                         const float* cd_row, const float* w2_s,
                                         const float* b2_s, int H, float y[NS][4]) {
  float acc[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[s][o] = 0.f;
  const float* abp = ab + cell;
#pragma unroll 4
  for (int h = 0; h < H; ++h) {
    const float a = __ldg(abp + (size_t)h * plane);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float act = fmaxf(a + cd_row[h * 3 + (NS == 3 ? s : 1)], 0.f);
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[s][o] = fmaf(act, w2_s[o * H + h], acc[s][o]);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int o = 0; o < 4; ++o) y[s][o] = acc[s][o] + b2_s[o];
}

// This thread's x/y halo cell of the block's tile window (the first NHALO
// threads own one each: the rows above and below, then the columns left and
// right): its plane index, mapped into the grid, and its window slot.
__device__ __forceinline__ void halo_cell(int tid, int nx, int ny, int periodic, int& halo,
                                          int& halo_w) {
  if (tid >= NHALO) return;
  int hx, hy;
  if (tid < TX) {
    hx = tid, hy = -1;
  } else if (tid < 2 * TX) {
    hx = tid - TX, hy = TY;
  } else if (tid < 2 * TX + TY) {
    hx = -1, hy = tid - 2 * TX;
  } else {
    hx = TX, hy = tid - 2 * TX - TY;
  }
  halo = pat::map_index(blockIdx.y * TY + hy, ny, periodic) * nx +
         pat::map_index(blockIdx.x * TX + hx, nx, periodic);
  halo_w = (hy + 1) * WX + (hx + 1);
}

// The mega-kernel body.
__global__ void __launch_bounds__(NT)
    k_mega(const float* __restrict__ ab, const float* __restrict__ cd,
           const float* __restrict__ w2t, const float* __restrict__ b2,
           float* __restrict__ tile_parts, int nx, int ny, int nz,
           int H, int zrows, int periodic, pat::StencilConsts k) {
  extern __shared__ float sh[];
  float* win = sh;                 // [2][4][WN]: t slice of a row, with halo
  float* red = win + 2 * 4 * WN;   // [2 * NT / 32]
  float* b2_s = red + 2 * NT / 32; // [4]
  float* w2_s = b2_s + 4;          // [4 * H]
  float* cd_s = w2_s + 4 * H;      // [zrows + 2][H * 3]: CD rows z0-1 .. z1

  const int tid = threadIdx.x, lx = tid % TX, ly = tid / TX;
  const int gx = blockIdx.x * TX + lx, gy = blockIdx.y * TY + ly;
  const bool valid = gx < nx && gy < ny;
  const int plane = nx * ny;
  const int z0 = blockIdx.z * zrows, z1 = min(z0 + zrows, nz);
  const int nrows = z1 - z0 + 2;

  for (int i = tid; i < 4 * H; i += NT) w2_s[i] = w2t[i];
  if (tid < 4) b2_s[tid] = b2[tid];
  for (int i = tid; i < nrows * H * 3; i += NT) {
    const int r = i / (H * 3);
    const int zr = pat::map_index(z0 - 1 + r, nz, periodic);
    cd_s[i] = cd[(size_t)zr * H * 3 + (i - r * H * 3)];
  }

  // Own cell (mapped into the grid for the threads of a ragged tile, whose
  // window entries valid neighbours may read) and this thread's halo cell.
  const int own = pat::map_index(gy, ny, periodic) * nx + pat::map_index(gx, nx, periodic);
  const int own_w = (ly + 1) * WX + (lx + 1);
  int halo = 0, halo_w = 0;
  halo_cell(tid, nx, ny, periodic, halo, halo_w);
  __syncthreads();

  // Publish the t slice of local row r into window buffer buf: own cell
  // (value given) and this thread's halo cell (evaluated here).
  auto publish = [&](int buf, int r, const float t_own[4]) {
    float* w = win + buf * 4 * WN;
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c * WN + own_w] = t_own[c];
    if (tid < NHALO) {
      float yh[1][4];
      mlp_cell<1>(ab, plane, halo, cd_s + r * H * 3, w2_s, b2_s, H, yh);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c * WN + halo_w] = yh[0][c];
    }
  };

  // Registers: t slice of rows z-1 (tm), z (tc), z+1 (tn); t-dt / t+dt of
  // row z (lo, hi). Local row r holds z = z0 - 1 + r.
  float tm[4], tc[4], lo[4], hi[4];
  {
    float y1[1][4], y3[3][4];
    mlp_cell<1>(ab, plane, own, cd_s, w2_s, b2_s, H, y1);
    mlp_cell<3>(ab, plane, own, cd_s + H * 3, w2_s, b2_s, H, y3);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tm[c] = y1[0][c];
      lo[c] = y3[0][c];
      tc[c] = y3[1][c];
      hi[c] = y3[2][c];
    }
    publish(0, 1, tc);
  }
  __syncthreads();

  const int ntiles = gridDim.x * gridDim.y, tile = blockIdx.y * gridDim.x + blockIdx.x;
  for (int z = z0; z < z1; ++z) {
    const int cur = (z - z0) & 1, r_next = z - z0 + 2;
    const bool last = z + 1 == z1;
    // Row z+1 at the own column: all three slices, or only the t slice on
    // the last row of the range (its t +- dt and halo are not needed).
    float tn[4], lo_n[4], hi_n[4];
    if (last) {
      float y1[1][4];
      mlp_cell<1>(ab, plane, own, cd_s + r_next * H * 3, w2_s, b2_s, H, y1);
#pragma unroll
      for (int c = 0; c < 4; ++c) tn[c] = lo_n[c] = hi_n[c] = y1[0][c];
    } else {
      float y3[3][4];
      mlp_cell<3>(ab, plane, own, cd_s + r_next * H * 3, w2_s, b2_s, H, y3);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo_n[c] = y3[0][c];
        tn[c] = y3[1][c];
        hi_n[c] = y3[2][c];
      }
      publish(cur ^ 1, r_next, tn);
    }

    // Residual of row z at the own cell.
    float a = 0.f, b = 0.f;
    if (valid) {
      const float* w = win + cur * 4 * WN;
      pat::Nbr f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* wc = w + c * WN;
        f[c] = pat::Nbr{tc[c],          wc[own_w - 1], wc[own_w + 1], wc[own_w - WX],
                        wc[own_w + WX], tm[c],         tn[c]};
      }
      float r[4];
      pat::cell_residual(k, f[0], f[1], f[2], f[3], lo, hi, r);
      pat::cell_squares(r, a, b);
    }
    pat::block_sum2<NT>(a, b, red);
    if (tid == 0) {
      tile_parts[(size_t)z * ntiles + tile] = a;
      tile_parts[((size_t)nz + z) * ntiles + tile] = b;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tm[c] = tc[c];
      tc[c] = tn[c];
      lo[c] = lo_n[c];
      hi[c] = hi_n[c];
    }
    __syncthreads();
  }
}

// Dynamic shared memory of k_mega (bytes).
inline size_t mega_smem_bytes(int H, int zrows) {
  return (size_t)(2 * 4 * WN + 2 * NT / 32 + 4 + 4 * H + (zrows + 2) * H * 3) * sizeof(float);
}

}  // namespace
