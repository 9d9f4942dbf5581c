// K6: the supervised-fit kernel of the coordinate MLP (the data loss and
// every MLP table gradient in one call), sm_90a.
//
// Replaces _build_fit_call of phys_autodiff_tpu/pallas/fit.py (:68). From the
// folded tables of K2 (AB [H, ny, nx], CD [nz, H, 1] at the one slice t,
// W2T [4, H], b2 [4]) and the packed target [nz, 4, ny * nx] it computes, per
// cell,
//   y = W2T relu(AB + CD[z]) + b2,  e = y - target,
//   gy = (2w/N) e (w_sigma on channel 0, w_u on 1..3),
//   dz1 = [AB + CD[z] > 0] W2 gy,  dAB += dz1 (over z),  dCD[z] += dz1 (over
//   cells),  dW2T += gy relu(AB + CD[z])^T,  db2 += gy,
// and the per-(z plane, tile) loss partials sum e_sigma^2 and sum |e_u|^2.
// The host adds those in a fixed order (kernels/residuals.finalize_partials)
// and pulls (dAB, dCD, dW2T, db2) back through the folds to (W1, b1, W2, b2,
// t) by autograd.
//
// Two launches, on the tiled MLP core of mlp_head.cuh (shared with K4), and
// no float atomics: every sum has a fixed order.
//   1. k_fit, a persistent grid of min(tile rows, 264) blocks, each walking
//      its contiguous range of 32 x 8 tile rows in chunks of up to ZC = 16
//      rows of one tile. Per chunk:
//      A  thread per cell: y of every row of the chunk in straight-line
//         groups of 16, 8, 4, 2 and 1 rows (AB read once a group, W2 and the
//         CD rows as float4 broadcasts), e and gy (gy to shared memory), the
//         rows' squared errors summed over each warp;
//      then the rows' loss tile partials (the warps' sums in order);
//      B  the core's backward: a warp per pair of hidden units, a lane per
//         tile column (8 cells), the chunk's rows inner; dAB leaves the
//         block once a (block, tile), dCD once a row, dW2T once a block.
//      Shared memory: gy [ZC][256] float4 (64 KB), the CD rows [ZC][HP],
//      W2 [HP] float4 and the dW2T sums [HP][4]: 64 KB + 96 HP bytes (76 KB
//      at H = 128, two blocks an SM); H reaches 1,724.
//   2. k_bwd_finalize<1>, k_bwd_reduce (mlp_head.cuh): dAB over the blocks
//      of each tile, dCD over tiles, dW2T and db2 over blocks.
//
// Bound on this card: FP32 operations. The function needs 29 H + 23
// operations a cell, an FMA counted as two: forward 10 H (add, max, 4 FMA);
// backward W2 . gy 8 H, the mask H, dAB H, dCD H, dW2 8 H; e, the squares,
// gy and db2 23. At H = 128 on 128x96x96 that is 4.41 GFLOP, 0.066 ms at
// 67 TFLOP/s. The compulsory bytes are the target (18.9 MB) and AB and dAB
// (6.3 MB each), 0.009 ms at 3.35 TB/s. The kernel recomputes relu(AB + CD)
// in B (2 H more a cell) and runs FFMA on the CUDA cores (W2 has 4 columns,
// too narrow for the tensor cores).

#include "mlp_head.cuh"

namespace {

using mlph::NT;
using mlph::NW;
using mlph::TX;
constexpr int ZC = 16;  // rows of a chunk (kernels/fit.py ZROWS)

// Dynamic shared memory of k_fit (bytes): gy, the CD rows, W2, the dW2T sums.
__host__ __device__ inline size_t fit_smem_bytes(int H) {
  const int HP = mlph::pad4(H);
  return (size_t)ZC * NT * sizeof(float4) + ((size_t)ZC * HP + 4 * (size_t)HP + 4 * (size_t)HP) * sizeof(float);
}

// What phase A of k_fit reads and writes for one chunk.
struct RowsArgs {
  const float* ab;
  const float* tgt;
  const float4* w2_s;
  const float* cd_s;
  float4* gy_s;
  float* red;
  size_t cell, plane;
  int z0, H, HP;
  bool valid;
  float scale_sigma, scale_u, b2[4];
};

// Phase A for the R rows zl0 .. zl0 + R - 1 of the chunk, thread per cell:
// y of each row (the hidden units in order, one FMA chain per output; W2
// and the CD rows as float4 broadcasts), e = y - target, gy to gy_s and
// into db, and the rows' squared errors summed over the warp into red.
template <int R>
__device__ __forceinline__ void fit_rows(const RowsArgs& a, int zl0, float (&db)[4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[R][4];
#pragma unroll
  for (int zl = 0; zl < R; ++zl)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[zl][o] = 0.f;
  if (a.valid) {
    const float* abp = a.ab + a.cell;
    for (int h = 0; h < a.HP; h += 4) {
      float av[4];
      float4 wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // past H: a clamped row times a zero weight
        av[j] = __ldg(abp + (size_t)min(h + j, a.H - 1) * a.plane);
        wv[j] = a.w2_s[h + j];
      }
#pragma unroll
      for (int zl = 0; zl < R; ++zl) {
        const float4 cv = *reinterpret_cast<const float4*>(a.cd_s + (zl0 + zl) * a.HP + h);
        const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float act = fmaxf(av[j] + cj[j], 0.f);
          acc[zl][0] = fmaf(act, wv[j].x, acc[zl][0]);
          acc[zl][1] = fmaf(act, wv[j].y, acc[zl][1]);
          acc[zl][2] = fmaf(act, wv[j].z, acc[zl][2]);
          acc[zl][3] = fmaf(act, wv[j].w, acc[zl][3]);
        }
      }
    }
  }
#pragma unroll
  for (int zl = 0; zl < R; ++zl) {
    float sa = 0.f, sb = 0.f;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.valid) {
      const float* tp = a.tgt + (size_t)(a.z0 + zl0 + zl) * 4 * a.plane + a.cell;
      const float e0 = (acc[zl][0] + a.b2[0]) - __ldg(tp);
      const float e1 = (acc[zl][1] + a.b2[1]) - __ldg(tp + a.plane);
      const float e2 = (acc[zl][2] + a.b2[2]) - __ldg(tp + 2 * a.plane);
      const float e3 = (acc[zl][3] + a.b2[3]) - __ldg(tp + 3 * a.plane);
      sa = e0 * e0;
      sb = (e1 * e1 + e2 * e2) + e3 * e3;
      g = make_float4(a.scale_sigma * e0, a.scale_u * e1, a.scale_u * e2, a.scale_u * e3);
      db[0] += g.x;
      db[1] += g.y;
      db[2] += g.z;
      db[3] += g.w;
    }
    a.gy_s[(zl0 + zl) * NT + tid] = g;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa = pat::add(sa, __shfl_down_sync(0xffffffffu, sa, off));
      sb = pat::add(sb, __shfl_down_sync(0xffffffffu, sb, off));
    }
    if (lane == 0) {
      a.red[((zl0 + zl) * NW + warp) * 2] = sa;
      a.red[((zl0 + zl) * NW + warp) * 2 + 1] = sb;
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
    k_fit(const float* __restrict__ ab, const float* __restrict__ cd,
          const float* __restrict__ w2t, const float* __restrict__ b2,
          const float* __restrict__ tgt, float* __restrict__ tile_parts,
          float* __restrict__ dab_part, float* __restrict__ dcd_part,
          float* __restrict__ dw2_part, float* __restrict__ db2_part, int nx, int ny, int nz,
          int H, float scale_sigma, float scale_u) {
  extern __shared__ float4 sh4[];
  const int HP = mlph::pad4(H);
  float4* gy_s = sh4;                                     // [ZC][NT]
  float4* w2_s = sh4 + ZC * NT;                           // [HP]
  float* cd_s = reinterpret_cast<float*>(w2_s + HP);      // [ZC][HP]
  float* dw_s = cd_s + ZC * HP;                           // [HP][4]
  __shared__ float red[2 * NW * ZC];                      // the rows' warp sums
  __shared__ float red2[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + mlph::TY - 1) / mlph::TY);
  const int nrows = ntiles * nz;
  const size_t plane = (size_t)nx * ny;
  mlph::load_w2(w2_s, w2t, H, HP);
  for (int i = tid; i < 4 * HP; i += NT) dw_s[i] = 0.f;
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  float* dab_blk = dab_part + (size_t)blockIdx.x * H * NT;  // slot blk + tile

  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZC, nz, ntx);
    const bool first = r == r0 || c.z0 == 0;
    __syncthreads();  // fit: the last chunk's B done with gy_s and cd_s
    mlph::load_cd<1>(cd_s, cd, c.z0, c.n, ZC, H, HP);
    __syncthreads();  // fit: the chunk's CD rows in

    // ---- A: the forward of every row, e, gy and the rows' squared errors --
    // In straight-line groups of 16, 8, 4, 2 and 1 rows (AB read once a
    // group), so that no branch on the chunk's row count sits in the loop
    // over the hidden units.
    const int gx = c.x0 + tid % TX, gyy = c.y0 + tid / TX;
    const bool valid = gx < nx && gyy < ny;
    const RowsArgs ra{ab, tgt, w2_s, cd_s, gy_s, red, valid ? (size_t)gyy * nx + gx : 0, plane, c.z0, H, HP,
                      valid, scale_sigma, scale_u, {b2r[0], b2r[1], b2r[2], b2r[3]}};
    int zl0 = 0;
    if (c.n == ZC) {
      fit_rows<ZC>(ra, 0, db);
      zl0 = ZC;
    }
    if (c.n - zl0 >= 8) fit_rows<8>(ra, zl0, db), zl0 += 8;
    if (c.n - zl0 >= 4) fit_rows<4>(ra, zl0, db), zl0 += 4;
    if (c.n - zl0 >= 2) fit_rows<2>(ra, zl0, db), zl0 += 2;
    if (c.n - zl0 >= 1) fit_rows<1>(ra, zl0, db);
    __syncthreads();  // fit: A done (gy_s and the rows' warp sums in)
    if (tid < 2 * c.n) {  // the rows' loss tile partials, the warps in order
      const int zl = tid / 2, k = tid % 2;
      float s = 0.f;
      for (int wi = 0; wi < NW; ++wi) s = pat::add(s, red[(zl * NW + wi) * 2 + k]);
      tile_parts[((size_t)k * nz + c.z0 + zl) * ntiles + c.tile] = s;
    }

    // ---- B: the backward of the chunk on the core ---------------------------
    float* slot = dab_blk + (size_t)c.tile * H * NT;
    for (int hp = warp; 2 * hp < H; hp += NW)
      mlph::bwd_item<1>(ab, gy_s, cd_s, w2_s, slot, dcd_part, dw_s, c, first, 2 * hp, H, HP, nx, ny,
                        ntiles);
    r += c.n;
  }
  __syncthreads();  // fit: the last B (dw_s complete)

  // ---- the block's partials ----------------------------------------------
  const size_t blk = blockIdx.x;
  mlph::store_dw2(dw2_part + blk * 4 * H, dw_s, H);
  pat::block_sum2<NT>(db[0], db[1], red2);
  __syncthreads();  // fit: red2 free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red2);
  if (tid == 0) {
#pragma unroll
    for (int o = 0; o < 4; ++o) db2_part[blk * 4 + o] = db[o];
  }
}

}  // namespace

// AB [H, ny, nx], CD [nz, H, 1], W2T [4, H], b2 [4], target [nz, 4, ny*nx];
// scratch: tile partials [2, nz, ntiles], dAB partials [nblk + ntiles - 1,
// H, 256], dCD partials [nz, ntiles, H], dW2T partials [nblk, 4, H], db2
// partials [nblk, 4]; outputs dAB [H, ny, nx], dCD [nz, H, 1], dW2T [4, H],
// db2 [4]. nblk = min(tile rows, NBLK) (the host computes it); the shared
// memory within a block's (the host gates).
extern "C" int pat_fit(const float* ab, const float* cd, const float* w2t, const float* b2,
                       const float* tgt, float* tile_parts, float* dab_part, float* dcd_part,
                       float* dw2_part, float* db2_part, float* dab, float* dcd, float* dw2t,
                       float* db2, int nx, int ny, int nz, int H, int nblk, float scale_sigma,
                       float scale_u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nrows = ((nx + TX - 1) / TX) * ((ny + mlph::TY - 1) / mlph::TY) * nz;
  const size_t smem = fit_smem_bytes(H);
  if (H < 1 || nblk < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
      smem + 4 * (2 * NW * ZC + 2 * NW) > (size_t)mlph::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k_fit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_fit<<<nblk, NT, smem, s>>>(ab, cd, w2t, b2, tgt, tile_parts, dab_part, dcd_part, dw2_part, db2_part, nx,
                               ny, nz, H, scale_sigma, scale_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mlph::launch_sums<1>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2, nx, ny,
                                   nz, H, nblk, s);
}
