// K3: the MLP -> residual -> loss-partials mega-kernel, sm_90a.
//
// Replaces _build_mega_call of phys_autodiff_tpu/pallas/mega.py (:316). The
// fields at t-dt, t, t+dt never reach device memory: the kernel evaluates
// the folded MLP (the AB / CD / W2T / b2 tables of K2) where the stencil
// needs a value, computes the residual through the shared body of
// stencil.cuh, and reduces R_sigma^2 and |R_u|^2 into per-(z plane, tile)
// partials [2, nz, ntiles] that K1's finalize pass adds in a fixed order (no
// atomics).
//
// Bound on this card: FP32 operations in the MLP (10 H a cell and slice, an
// FMA counted as two, 30 H for the three slices; 0.069 ms at H = 128 on
// 128x96x96, chip_smoke.py's work table). The compulsory device-memory
// traffic is only the tables and 8 B a (tile, plane).
//
// Design: the forward of the tiled MLP core (mlp_head.cuh fwd_upto, shared
// with K2 and K4's fields pass), on a persistent grid of min(tile rows, 264)
// blocks. Block b walks its contiguous range of 32 x 8 tile rows
// (tile-major, z fastest; at 128x96x96 about 17.5 rows, at most two tiles)
// in chunks of ZF = 3 rows of one tile. A run is the rows of one tile in a
// block's range, za .. zb - 1.
//   * The stencil of row z reads the t slice of row z with a one-cell x/y
//     halo, the t slice of rows z -+ 1 at the tile's cells and t -+ dt at
//     the cell. Per chunk, each thread evaluates the three slices of its
//     cell for the chunk's rows (AB read once for all nine values) and
//     stores the t slice into a shared window ring (rows with halo) and
//     t+dt minus t-dt (the residual reads only that difference, rounded
//     as K1 rounds it) into a shared ring of its own column.
//   * The z carry: the residual of row z runs once row z + 1 is in, so a
//     chunk finishes rows z0 - 1 .. z0 + n - 2 and the window carries rows
//     z0 - 2 and z0 - 1 to the next chunk, as the TPU kernel carried its
//     window across its sequential grid (pallas/mega.py:372-376). A run
//     evaluates the t slice of rows za - 1 and zb (periodic or clamped) at
//     the tile's cells once: two t-slice rows a (block, run).
//   * The halo over all eight warps, inside the forward's loop: the 80 x/y
//     halo cells of each row (top, bottom, left, right; no corner: the
//     stencil has no diagonal) make 240 t-slice values a 3-row chunk, one
//     side value (mlp_head.cuh Side) for each of threads 0-239, and rows
//     za - 1 and zb one more for every thread where the chunk starts or ends
//     its run. A side value is one more FMA chain in the loop over hidden
//     units, so its AB loads wait behind the forward's arithmetic, and every
//     warp carries the same count: the critical path of a chunk is the mean
//     warp's. (Run as t-slice loops of their own after the forward, the
//     halo values are latency-bound: 49% of a block's cycles on an H100.
//     Chunks of 4 rows need two side values on some threads, which spilled
//     registers.)
//   * The residuals of a chunk's finished rows (pat::cell_residual_dlt,
//     K1's body) and their squares (pat::cell_squares), all rows at once,
//     go through warp_sum2's tree into one barrier's scratch, and warp k
//     adds row k's warp sums (warps_sum2): pat::block_sum2's tree, so the
//     partials are those K1 gives for the same fields, and K2's fields are
//     K3's to the bit: K3's loss equals K2 -> K1's.
//   * Three barriers a chunk: the next chunk's CD rows are copied
//     (cp.async) while this chunk's residuals run.
// Shared memory: W2 [HP] float4, the CD table [HP][ZF + 2][4] (the chunk's
// rows and the run's outer rows; three slices, padded to a float4 a row),
// the window ring [ZF + 3][4][34 x 10] (rows z0 - 2 .. z0 + n) and the
// slice-difference ring [ZF + 1][4][256]: 49,024 + 96 HP bytes (61 KB at
// H = 128, two blocks an SM); the host gates H <= 1908. FMAs are allowed in
// the MLP (class MLP_INFER_REL); the residual body keeps the staged arm's
// per-operation rounding.
//
// The bf16 tier (k_mega<true, 3>, pat_mega_partials_bf16): the same walk,
// rings and residuals; the forward runs on the tensor cores (fwd_bf16 /
// fwd_pass, the chain K2's bf16 tier gives each value) in three passes a
// chunk, each one loop over the k-steps with its AB loads at the top:
// passes 0 and 1 give each warp one 16-cell fragment of its tile row, the
// chunk's rows in three slices and, where the chunk starts or ends its
// run, rows za - 1 / zb in the t slice beside them (the outer rows share
// the fragment's AB loads: no pass of their own); pass 2 gives warps 0-4
// one 16-cell fragment each of the 80 halo cells, the chunk's rows in the
// t slice (inside pass 1 it spilled registers; dealt over all eight warps
// item by item, each item loading AB of its own cell and row, it was
// slower on an H100). The chunk's descriptor is read from shared memory
// where the passes need it, so that it stays out of the registers of their
// products (no spill). The CUDA cores keep the add, half a convert and half
// a bf16x2 max per (cell, slice, hidden unit): 2 H a value, 6 H a cell (6.6 H with the halo
// and a run's outer rows), against 30 H in f32. Bound at H = 128 on
// 128x96x96: the CUDA-core operations, 6 H + 73 a cell, 0.0147 ms at 67
// TFLOP/s (chip_smoke.py's work table).
// Shared memory as above with HP padded to 16 (W2's B fragments take the
// 16 B a hidden unit of the float4 W2): the host gates H <= 1904.

#include <type_traits>

#include "mlp_mma.cuh"

namespace {

using mlph::NT;
using mlph::NW;
using mlph::TX;
using mlph::TY;
constexpr int WX = TX + 2, WY = TY + 2, WN = WX * WY;  // window of a row, with x/y halo
constexpr int NHALO = 2 * TX + 2 * TY;                 // its halo cells without corners

// The walk's sizes for chunks of ZF rows (3 in both tiers: ZF_BF16).
template <int ZF_>
struct Walk {
  static constexpr int ZF = ZF_;                          // rows of a chunk
  static constexpr int ZT = ZF + 2;                       // rows of its CD table: za - 1 and zb too
  static constexpr int CDS = ZT * 4;                      // floats of a hidden unit's table row
  static constexpr int NSLOT = ZF + 3;                    // window ring: rows z0 - 2 .. z0 + n
  static constexpr int NLH = ZF + 1;                      // slice-difference ring: rows z0 - 1 .. z0 + n - 1
  static constexpr int XY = (NHALO * ZF + NT - 1) / NT;  // x/y halo values a thread, at most (f32)
};

// Dynamic shared memory of k_mega (bytes), and its static rows' warp sums.
__host__ __device__ inline size_t mega_smem_bytes(int H, bool bf16, int zf) {
  const size_t HP = bf16 ? mma16::pad16(H) : mlph::pad4(H);
  return (HP * (4 + (zf + 2) * 4) + (size_t)(zf + 3) * 4 * WN + (size_t)(zf + 1) * 4 * NT) * sizeof(float);
}
__host__ __device__ inline size_t mega_static_bytes(bool bf16, int zf) {
  return (zf + 1) * 2 * NW * sizeof(float) + (bf16 ? 7 * sizeof(int) : 0);
}

// The bf16 tier's chunk in shared memory: its descriptor's fields.
enum { CI_X0, CI_Y0, CI_Z0, CI_N, CI_FIRST, CI_LAST, CI_ZA, CI_COUNT };

// The bf16 tier's chunk rows: 3, as f32 (chunks of 4 rows, which keep two
// blocks an SM to H = 496, spill and were slower on an H100).
constexpr int ZF_BF16 = 3;

// Halo cell j (0 <= j < NHALO) of a tile: its offset from the tile origin.
__device__ __forceinline__ void halo_at(int j, int& hx, int& hy) {
  if (j < TX) {
    hx = j, hy = -1;
  } else if (j < 2 * TX) {
    hx = j - TX, hy = TY;
  } else if (j < 2 * TX + TY) {
    hx = -1, hy = j - 2 * TX;
  } else {
    hx = TX, hy = j - 2 * TX - TY;
  }
}

// f(std::integral_constant<int, x>{}) for the runtime x in [0, XMAX].
template <int XMAX, int X = 0, class F>
__device__ __forceinline__ void dispatch(int x, F& f) {
  if (x == X) {
    f(std::integral_constant<int, X>{});
  } else if constexpr (X < XMAX) {
    dispatch<XMAX, X + 1>(x, f);
  }
}

// The bf16 tier's forward pass over one 16-cell fragment (cells on M, the
// thread's at ab_lo / ab_hi): S = 3 (a tile row's fragment) R rows of the
// chunk in three slices and NO outer rows of the run (table rows ro[0],
// ro[1] from the chunk's first: -1 for za - 1, n for zb) in the t slice,
// or S = 1 (16 x/y halo cells) R rows in the t slice. One loop over the
// k-steps, the k-step's AB loaded at its top (loading the next k-step's
// before the current products spilled registers and was slower on an H100).
// Each value is its own chain of k-steps from 0, in order, on m16n8k16 with
// the operands of mlp_mma.cuh's fwd_tile (the chain K2's bf16 tier gives
// it).
template <int ZF, int S, int R, int NO>
__device__ __forceinline__ void fwd_pass(const float* __restrict__ ab_lo, const float* __restrict__ ab_hi,
                                         size_t plane, const uint2* w2f, const float* cd_c, const int (&ro)[2],
                                         int H, float (&acc)[R][S][4], float (&oacc)[2][4]) {
  constexpr int CDS = Walk<ZF>::CDS;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[i][s][k] = 0.f;
    oacc[0][k] = oacc[1][k] = 0.f;
  }
  const int nkb = (H + 15) >> 4, nfull = H >> 4;
  // AB at the thread's cells and hidden unit 16 kb + 2t, and that unit's CD table row
  const float* pl = ab_lo + (size_t)(2 * t) * plane;
  const float* ph = ab_hi + (size_t)(2 * t) * plane;
  const float* cdk = cd_c + 2 * t * CDS;
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb, pl += 16 * plane, ph += 16 * plane, cdk += 16 * CDS) {
    float v[2][4];
    mma16::ab_kstep(pl, plane, 16 * kb + 2 * t, H, kb < nfull, v[0]);
    mma16::ab_kstep(ph, plane, 16 * kb + 2 * t, H, kb < nfull, v[1]);
    const uint2 w = w2f[kb * 32 + lane];
    // the CD table row of the thread's hidden unit j (2t + {0, 1, 8, 9})
    auto hrow = [&](int j) { return cdk + ((j & 1) + 8 * (j >> 1)) * CDS; };
    // bf16(max(AB + CD, 0)) of the pairs (the fragment's a0..a3) times W2
    auto frag = [&](float (&d)[4], const float (&c)[4]) {
      mma16::mma16816(d, mma16::relu2(v[0][0] + c[0], v[0][1] + c[1]), mma16::relu2(v[1][0] + c[0], v[1][1] + c[1]),
                      mma16::relu2(v[0][2] + c[2], v[0][3] + c[3]), mma16::relu2(v[1][2] + c[2], v[1][3] + c[3]),
                      w.x, w.y);
    };
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float c[4];  // slice s of row i (S = 1: the t slice)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = hrow(j)[i * 4 + (S == 1 ? 1 : s)];
        frag(acc[i][s], c);
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = hrow(j)[ro[o] * 4 + 1];
      frag(oacc[o], c);
    }
  }
}

// The bf16 tier's forward of a chunk (mlp_mma.cuh), pass m: the window
// rows and slice differences that the f32 forward stores, from tensor-core
// fragments. Passes 0 and 1: warp w takes its tile row's 32 cells as two
// 16-cell fragments, one a pass: the chunk's rows in three slices and rows
// za - 1 / zb (t slice) where the chunk starts / ends its run. Pass 2:
// warps 0-4 take one 16-cell fragment each of the 80 x/y halo cells, the
// chunk's rows in the t slice. Lanes t < 2 hold outputs 2t, 2t + 1 of cells
// g and g + 8. Every value is the chain K2 gives it, so the window holds
// K2's fields to the bit.
template <int ZF>
__device__ __forceinline__ void fwd_bf16(const float* __restrict__ ab, const uint2* w2f, const float* cd_s,
                                         float* win, float* dlt_s, const float* __restrict__ b2,
                                         const volatile int* ci, int nx, int ny, int periodic, int H, int m) {
  constexpr int NSLOT = Walk<ZF>::NSLOT, NLH = Walk<ZF>::NLH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (m == 2 && warp >= NHALO / 16) return;  // warp-uniform
  // the chunk (read where each value is needed, so that none stays in a
  // register across the pass's products)
  mlph::Chunk c;
  c.x0 = ci[CI_X0], c.y0 = ci[CI_Y0], c.n = ci[CI_N];
  const int first = ci[CI_FIRST], last = ci[CI_LAST];
  const size_t plane = (size_t)nx * ny;
  const float* cd_c = cd_s + first * 4;  // the chunk's rows; za - 1 is row -1 from there, zb row n
  auto cell_ab = [&](int hx, int hy) {
    return ab + (size_t)pat::map_index(c.y0 + hy, ny, periodic) * nx + pat::map_index(c.x0 + hx, nx, periodic);
  };
  // The t-slice value (v0, v1: outputs 2t, 2t + 1, b2 added) of window
  // position pos in ring row q.
  auto put = [&](int q, int pos, float v0, float v1) {
    float* w = win + (q % NSLOT) * 4 * WN;
    w[2 * t * WN + pos] = v0 + __ldg(b2 + 2 * t);
    w[(2 * t + 1) * WN + pos] = v1 + __ldg(b2 + 2 * t + 1);
  };
  // the outer rows of this chunk: table rows (ring rows: 0 for za - 1, n +
  // z0 - za + 1 for zb)
  const int no = first + last;
  int ro[2];
  ro[0] = first ? -1 : c.n, ro[1] = c.n;
  // the fragment's cells: (hx, hy) from the tile origin
  int hx[2], hy[2];
  if (m == 2) {
    halo_at(16 * warp + g, hx[0], hy[0]);
    halo_at(16 * warp + g + 8, hx[1], hy[1]);
  } else {
    hx[0] = 16 * m + g, hx[1] = hx[0] + 8, hy[0] = hy[1] = warp;
  }
  const float* ab_lo = cell_ab(hx[0], hy[0]);
  const float* ab_hi = cell_ab(hx[1], hy[1]);
  auto own = [&](auto rr, auto nn) {
    constexpr int R = decltype(rr)::value, NO = decltype(nn)::value;
    float acc[R][3][4], oacc[2][4];
    fwd_pass<ZF, 3, R, NO>(ab_lo, ab_hi, plane, w2f, cd_c, ro, H, acc, oacc);
    if (t >= 2) return;
    const int q0 = ci[CI_Z0] - ci[CI_ZA] + 1;  // the ring row of the chunk's first row
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = q0 + i;
      float* dr = dlt_s + (q % NLH) * 4 * NT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 2 * half, cell = warp * TX + hx[half];
        const float bo0 = __ldg(b2 + 2 * t), bo1 = __ldg(b2 + 2 * t + 1);
        put(q, (warp + 1) * WX + hx[half] + 1, acc[i][1][e], acc[i][1][e + 1]);
        dr[2 * t * NT + cell] = pat::sub(acc[i][2][e] + bo0, acc[i][0][e] + bo0);
        dr[(2 * t + 1) * NT + cell] = pat::sub(acc[i][2][e + 1] + bo1, acc[i][0][e + 1] + bo1);
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int qo = o == 0 && first ? 0 : q0 + c.n;
      put(qo, (warp + 1) * WX + hx[0] + 1, oacc[o][0], oacc[o][1]);
      put(qo, (warp + 1) * WX + hx[1] + 1, oacc[o][2], oacc[o][3]);
    }
  };
  auto halo = [&](auto rr) {
    constexpr int R = decltype(rr)::value;
    float acc[R][1][4], oacc[2][4];
    fwd_pass<ZF, 1, R, 0>(ab_lo, ab_hi, plane, w2f, cd_c, ro, H, acc, oacc);
    if (t >= 2) return;
    const int q0 = ci[CI_Z0] - ci[CI_ZA] + 1;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        put(q0 + i, (hy[half] + 1) * WX + hx[half] + 1, acc[i][0][2 * half], acc[i][0][2 * half + 1]);
  };
  auto rows = [&](auto rr) {
    if (m == 2) halo(rr);
    else if (no == 0) own(rr, std::integral_constant<int, 0>{});
    else if (no == 1) own(rr, std::integral_constant<int, 1>{});
    else own(rr, std::integral_constant<int, 2>{});
  };
  if constexpr (ZF == 4) {
    if (c.n == 4) {
      rows(std::integral_constant<int, 4>{});
      return;
    }
  }
  if (c.n == 3) rows(std::integral_constant<int, 3>{});
  else if (c.n == 2) rows(std::integral_constant<int, 2>{});
  else rows(std::integral_constant<int, 1>{});
}

template <bool BF16, int ZF>
__global__ void __launch_bounds__(NT, 2)
    k_mega(const float* __restrict__ ab, const float* __restrict__ cd,
           const float* __restrict__ w2t, const float* __restrict__ b2,
           float* __restrict__ tile_parts, int nx, int ny, int nz, int H, int periodic,
           pat::StencilConsts k) {
  using W = Walk<ZF>;
  extern __shared__ float4 sh4[];
  const int HP = BF16 ? mma16::pad16(H) : mlph::pad4(H);
  float4* w2_s = sh4;                                // [HP] (bf16: W2's B fragments [2 HP] uint2)
  float* cd_s = reinterpret_cast<float*>(sh4 + HP);  // [HP][CDS]: rows z0 - first .. z0 + n - 1 + last
  float* win = cd_s + HP * W::CDS;                   // [NSLOT][4][WN]
  float* dlt_s = win + W::NSLOT * 4 * WN;            // [NLH][4][NT]: t+dt minus t-dt
  __shared__ float red[(ZF + 1) * 2 * NW];
  __shared__ volatile int ci[BF16 ? CI_COUNT : 1];  // bf16: the chunk's descriptor (mega_static_bytes)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, lx = tid % TX, ly = tid / TX;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  const size_t plane = (size_t)nx * ny;
  const int own_w = (ly + 1) * WX + lx + 1;
  if constexpr (BF16) {
    mma16::load_w2_frags<false>(reinterpret_cast<uint2*>(sh4), w2t, H, HP);
  } else {
    mlph::load_w2(w2_s, w2t, H, HP);
  }
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  // The chunk from tile row r: where its run starts (za - 1 heads its CD
  // table) and ends (zb closes it), and its table's rows.
  struct Rows {
    mlph::Chunk c;
    int first, last, nt;
  };
  auto rows_at = [&](int r) {
    Rows w;
    w.c = mlph::chunk_at(r, r1, ZF, nz, ntx);
    w.first = r == r0 || w.c.z0 == 0, w.last = r + w.c.n == r1 || w.c.z0 + w.c.n == nz;
    w.nt = w.c.n + w.first + w.last;
    return w;
  };
  // The CD table of the chunk from tile row r, copied asynchronously.
  auto fetch_cd = [&](int r) {
    const Rows w = rows_at(r);
    mlph::load_cd_rows<3, W::ZT, 4, true>(cd_s, cd, 3, 0, w.c.z0 - w.first, w.nt, nz, periodic, H, HP);
  };
  if (r0 < r1) fetch_cd(r0);
  int za = 0;  // first row of the current run; row z sits at ring index z - za + 1
  // The rows' warp sums of a chunk, added into its tile partials by warp k
  // for row k.
  auto finish = [&](const float* rd, int nr, size_t z_first, int tile) {
    if (warp < nr) {
      float sa, sb;
      pat::warps_sum2<NW>(rd + warp * 2 * NW, rd + (warp * 2 + 1) * NW, sa, sb);
      if (lane == 0) {
        const size_t z = z_first + warp;
        tile_parts[z * ntiles + tile] = sa;
        tile_parts[(nz + z) * ntiles + tile] = sb;
      }
    }
  };

  for (int r = r0; r < r1;) {
    const Rows w = rows_at(r);
    const mlph::Chunk& c = w.c;
    const int first = w.first, last = w.last;
    if (first) za = c.z0;
    if constexpr (BF16) {
      if (tid == 0) {  // the chunk's descriptor, for the bf16 forward
        ci[CI_X0] = c.x0, ci[CI_Y0] = c.y0, ci[CI_Z0] = c.z0, ci[CI_N] = c.n;
        ci[CI_FIRST] = first, ci[CI_LAST] = last, ci[CI_ZA] = za;
      }
    }
    mlph::wait_cd_rows();
    __syncthreads();  // mega: the chunk's CD rows in; the last chunk done with the rings and red

    // ---- the forward: the chunk's rows at the cell, with the halo ----------
    // Chunk row k is row z = z0 + k, at ring index q = z - za + 1.
    if constexpr (BF16) {
      // the two fragments of each warp's tile row, then the halo
      const uint2* w2f = reinterpret_cast<const uint2*>(sh4);
      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 0);
      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 1);
      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 2);
    } else {
      // This thread's cell, mapped into the grid for the threads of a ragged
      // tile (valid neighbours read their window entries).
      const size_t own =
          (size_t)pat::map_index(c.y0 + ly, ny, periodic) * nx + pat::map_index(c.x0 + lx, nx, periodic);
      auto store = [&](int k, const float (&y)[3][4]) {
        const int q = c.z0 + k - za + 1;
        float* wr = win + (q % W::NSLOT) * 4 * WN;
        float* dr = dlt_s + (q % W::NLH) * 4 * NT;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          wr[o * WN + own_w] = y[1][o];
          dr[o * NT + tid] = pat::sub(y[2][o], y[0][o]);
        }
      };
      // The side values of this thread, t slice only: its x/y halo items
      // tid + NT j (cell i % NHALO of chunk row i / NHALO; NHALO n <= XY NT
      // items), then rows za - 1 and zb at the thread's cell where the chunk
      // starts or ends its run. Their count is warp-uniform, so the loop over
      // hidden units has no branch.
      const int nxy = NHALO * c.n;
      int nxyw = 0, pos_xy[W::XY], q_xy[W::XY], cd_xy[W::XY];
      const float* ab_xy[W::XY];
#pragma unroll
      for (int j = 0; j < W::XY; ++j) {
        nxyw += warp * 32 + j * NT < nxy;
        const int i = tid + j * NT < nxy ? tid + j * NT : 0, zl = i / NHALO;
        int hx, hy;
        halo_at(i % NHALO, hx, hy);
        ab_xy[j] = ab + (size_t)pat::map_index(c.y0 + hy, ny, periodic) * nx +
                   pat::map_index(c.x0 + hx, nx, periodic);
        pos_xy[j] = tid + j * NT < nxy ? (hy + 1) * WX + hx + 1 : -1;
        q_xy[j] = c.z0 + zl - za + 1;
        cd_xy[j] = zl * 4 + 1;  // row zl's t slice in the chunk's table rows
      }
      // Side value e: x/y item e (e < nxyw), else za - 1 (the first after them
      // where the run starts), else zb. e is a constant wherever it is used.
      auto kind = [&](int e) { return e < nxyw ? e : e == nxyw && first ? W::XY : W::XY + 1; };
      auto side_store = [&](int e, const float (&y)[4]) {
        int pos = own_w, q = kind(e) == W::XY ? 0 : c.z0 + c.n - za + 1;
#pragma unroll
        for (int j = 0; j < W::XY; ++j)
          if (kind(e) == j) pos = pos_xy[j], q = q_xy[j];
        if (pos >= 0) {
          float* w = win + (q % W::NSLOT) * 4 * WN;
#pragma unroll
          for (int o = 0; o < 4; ++o) w[o * WN + pos] = y[o];
        }
      };
      // The chunk's rows start at table row `first`; za - 1 is row -1 from
      // there, zb row n.
      const float* cd_c = cd_s + first * 4;
      auto run = [&](auto x) {
        constexpr int X = decltype(x)::value;
        mlph::Side<X> side;
#pragma unroll
        for (int e = 0; e < X; ++e) {
          side.ab[e] = ab + own, side.cd[e] = kind(e) == W::XY ? -4 + 1 : c.n * 4 + 1;
#pragma unroll
          for (int j = 0; j < W::XY; ++j)
            if (kind(e) == j) side.ab[e] = ab_xy[j], side.cd[e] = cd_xy[j];
        }
        mlph::fwd_upto<3, ZF, X, 4>(ab, plane, own, w2_s, cd_c, W::CDS, b2r, 0, c.n, H, side, store, side_store);
      };
      dispatch<W::XY + 2>(nxyw + first + last, run);
    }
    __syncthreads();  // mega: the chunk's window rows and slice differences in
    if (r + c.n < r1) fetch_cd(r + c.n);  // the next chunk's table, while the residuals run

    // ---- the residuals of the finished rows z0 + k0 + j, j < nr -----------
    // (rows z0 - 1 .. z0 + n - 2, from z0 where the run starts, to z0 + n - 1
    // where it ends; all at once for the ILP).
    const int k0 = first ? 0 : -1, nr = (last ? c.n : c.n - 1) - k0;
    const bool valid = c.x0 + lx < nx && c.y0 + ly < ny;

    float a[ZF + 1], b[ZF + 1];
#pragma unroll
    for (int j = 0; j < ZF + 1; ++j) {
      a[j] = b[j] = 0.f;
      if (valid && j < nr) {
        const int q = c.z0 + k0 + j - za + 1;
        const float* wr = win + (q % W::NSLOT) * 4 * WN;
        const float* wm = win + ((q - 1) % W::NSLOT) * 4 * WN;
        const float* wp = win + ((q + 1) % W::NSLOT) * 4 * WN;
        const float* dr = dlt_s + (q % W::NLH) * 4 * NT;
        pat::Nbr f[4];
        float dl[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const float* wc = wr + o * WN;
          f[o] = pat::Nbr{wc[own_w],      wc[own_w - 1],         wc[own_w + 1],        wc[own_w - WX],
                          wc[own_w + WX], wm[o * WN + own_w], wp[o * WN + own_w]};
          dl[o] = dr[o * NT + tid];
        }
        float res[4];
        pat::cell_residual_dlt(k, f[0], f[1], f[2], f[3], dl, res);
        pat::cell_squares(res, a[j], b[j]);
      }
    }
    // warp_sum2 of each row, the rows interleaved.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < ZF + 1; ++j)
        if (j < nr) {
          a[j] = pat::add(a[j], __shfl_down_sync(0xffffffffu, a[j], off));
          b[j] = pat::add(b[j], __shfl_down_sync(0xffffffffu, b[j], off));
        }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < ZF + 1; ++j)
        if (j < nr) {
          red[j * 2 * NW + warp] = a[j];
          red[(j * 2 + 1) * NW + warp] = b[j];
        }
    }
    __syncthreads();  // mega: the rows' warp sums in
    finish(red, nr, c.z0 + k0, c.tile);
    r += c.n;
  }
}

}  // namespace

namespace {

template <bool BF16, int ZF>
int launch(const float* ab, const float* cd, const float* w2t, const float* b2, float* tile_parts, int nx, int ny,
           int nz, int H, int nblk, int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy,
           float inv2hz, void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  const int nrows = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * nz;
  const size_t smem = mega_smem_bytes(H, BF16, ZF);
  if (H < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
      smem + mega_static_bytes(BF16, ZF) > (size_t)mlph::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k_mega<BF16, ZF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_mega<BF16, ZF><<<nblk, NT, smem, (cudaStream_t)stream>>>(ab, cd, w2t, b2, tile_parts, nx, ny, nz, H, periodic,
                                                             k);
  return (int)cudaGetLastError();
}

}  // namespace

// AB [H, ny, nx], CD [nz, H, 3], W2T [4, H], b2 [4]; tile partials
// [2, nz, ntiles]. nblk = min(tile rows, NBLK) (the host computes it and
// gates H by the shared memory).
extern "C" int pat_mega_partials(const float* ab, const float* cd, const float* w2t,
                                 const float* b2, float* tile_parts, int nx, int ny, int nz, int H,
                                 int nblk, int periodic, int upwind, float inv2dt, float inv2hx,
                                 float inv2hy, float inv2hz, void* stream) {
  return launch<false, 3>(ab, cd, w2t, b2, tile_parts, nx, ny, nz, H, nblk, periodic, upwind, inv2dt, inv2hx,
                          inv2hy, inv2hz, stream);
}

// The bf16 tier: the same arguments.
extern "C" int pat_mega_partials_bf16(const float* ab, const float* cd, const float* w2t,
                                      const float* b2, float* tile_parts, int nx, int ny, int nz, int H,
                                      int nblk, int periodic, int upwind, float inv2dt, float inv2hx,
                                      float inv2hy, float inv2hz, void* stream) {
  return launch<true, ZF_BF16>(ab, cd, w2t, b2, tile_parts, nx, ny, nz, H, nblk, periodic, upwind, inv2dt, inv2hx,
                               inv2hy, inv2hz, stream);
}
