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
// in B (2 H more a cell) and runs FFMA on the CUDA cores (W2 has 4 columns).
//
// The bf16 tier (pat_fit_bf16), as the TPU's (pallas/fit.py:128-190):
// y = bf16(a1) . bf16(W2), dW2T = bf16(gy)^T . bf16(a1), da1 = bf16(gy) .
// bf16(W2)^T, float32 sums, on the tensor cores (mma.sync, bf16 operands;
// layer 1 stays the float32 add a1 = max(AB + CD, 0)). It runs on a kernel
// of its own, bfit::k_fit_bf16<ZC>: a block walks its rows in chunks of up
// to ZC rows of one tile, ZC as deep as two blocks an SM allow (fit_zc: 24
// at H = 128, so that each block's run of one tile at 128x96x96 is one
// chunk and its dAB slot is stored once, never read back). Per chunk:
//   A  the forward: a warp per tile row, two 16-cell fragments (M), groups
//      of up to 8 rows, the group's target rows loaded before its products
//      and AB of the next k-step before the current one's; y, e, gy (bf16,
//      to the chunk's gy rows) and the rows' squared errors;
//   B  the backward: a warp per 16 hidden units (M), the tile's cells on N
//      and K. Per tile row, AB and the dAB slot of the thread's (hidden
//      unit, cell) pairs in registers; per pair of rows, the two rows' gy of
//      the tile row's 32 cells by one ldmatrix (da1's B operands) and one
//      ldmatrix.trans (dW2's); per row, da1^T = [W2 | 0] . gy (even row) or
//      [0 | W2] . gy (odd row) by m16n8k8, the mask, dAB and dCD on its C
//      fragments, dW2 += bf16(a1) . gy by m16n8k16 into an accumulator of
//      each row parity (two independent chains);
// while the next chunk's CD rows are copied into the other of two buffers
// (cp.async); two barriers a chunk. gy of two rows shares a 16-byte bf16
// row a cell, [gy(2p) | gy(2p + 1)] (the half-zero W2 operands pick a row):
// 4 KB a row pair, one layout for both products.
// The walk of K7 bf16 (one row an interval, the next row's forward beside
// this one's backward) does not pay here: dAB sums over the rows, so every
// chunk boundary costs a load and a store of the block's dAB slot (timed on
// an H100 with kernels/variant_bench.py). The CUDA cores keep the add, half a
// convert and half a bf16x2 max of the forward and, in the backward, the
// add, the mask's compare and the dAB and dCD adds under it and half a
// convert and max a (cell, row, hidden unit), 7.5 H + 23 in all: 0.017 ms at
// H = 128 on 128x96x96 at 67 TFLOP/s, against 48 H a cell of tensor-core
// FLOP as issued (0.0073 ms at 989 TFLOP/s). Shared memory: W2's B
// fragments, the dW2T sums, the CD rows of two chunks [2][ZC][HP], gy
// [ZC / 2][256] x 16 B, each warp's dCD rows [ZC][16] and the rows' loss
// sums [ZC][8][2][2] (fit_layout; 91 KB at H = 128, two blocks an SM); the
// host gates H <= 1600.

#include "mlp_mma.cuh"

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
    {
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
    }
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
      mlph::bwd_item<1>(ab, gy_s, cd_s, w2_s, slot, dcd_part, dw_s, c, first, 2 * hp, H, HP, nx, ny, ntiles);
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

// ---- the bf16 tier on the tensor cores -------------------------------------
namespace bfit {

using mma16::ldsm4;
using mma16::ldsm4_t;
using mma16::mma1688;
using mma16::mma16816;
using mma16::pack2;
using mma16::relu2;
constexpr int RMAX = 8;                    // most rows of a forward group
constexpr int SMEM_2BLK = 115712 - 2 * NW * 4;  // dynamic bytes a block at two blocks an SM

// Dynamic shared memory, byte offsets, at hidden width H and zc rows a
// chunk (HP = H padded to 16): W2's B fragments [2 HP] uint2, the dW2T sums
// [HP][4] float, the CD rows of two chunks [2][zc][HP] float (the chunk's
// and the next one's, copied while this one runs), gy [zc / 2][NT] x 16 B
// (bf16 [gy(2p) | gy(2p + 1)] a cell), each warp's dCD rows [NW][zc][16]
// float and the rows' loss sums [zc][NW][2][2] float.
struct Layout {
  int w2f, dw, cd, gy, dcd, red, total;
};

__host__ __device__ inline Layout fit_layout(int H, int zc) {
  const int HP = mma16::pad16(H);
  Layout m;
  m.w2f = 0;
  m.dw = m.w2f + 2 * HP * 8;
  m.cd = m.dw + HP * 4 * 4;
  m.gy = m.cd + 2 * zc * HP * 4;
  m.dcd = m.gy + (zc / 2) * NT * 16;
  m.red = m.dcd + NW * zc * 16 * 4;
  m.total = m.red + zc * NW * 2 * 2 * 4;
  return m;
}

// The chunk depth: the deepest of 24, 16, 8 and 4 rows whose layout keeps
// two blocks an SM (24 at H = 128: a block's whole run of one tile's rows at
// 128x96x96, so that its dAB slot is written once), else the deepest of 16,
// 8 and 4 that fits a block.
__host__ __device__ inline int fit_zc(int H) {
  const int zcs[4] = {24, 16, 8, 4};
  for (int zc : zcs)
    if (fit_layout(H, zc).total <= SMEM_2BLK) return zc;
  for (int zc : zcs)
    if (zc < 24 && fit_layout(H, zc).total + 2 * NW * 4 <= mlph::SMEM_LIMIT) return zc;
  return 4;
}

// The CD rows of chunk c into cds [ZC][HP] (one of the two chunks' buffers)
// by 4-byte cp.async (rows past c.n and hidden units past H keep what they
// hold: finite values, as the buffers are zeroed first; an odd chunk's row
// n meets a zero gy row).
template <int ZC>
__device__ __forceinline__ void copy_cd(float* cds, const float* __restrict__ cd, const mlph::Chunk& c, int H,
                                        int HP) {
  for (int i = threadIdx.x; i < c.n * H; i += NT) {
    const int zl = i / H, h = i - zl * H;
    const unsigned a = (unsigned)__cvta_generic_to_shared(cds + zl * HP + h);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(cd + (size_t)(c.z0 + zl) * H + h)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The forward of R rows (zl0 ..) of one 16-cell fragment: acc[i] gets, in
// C-fragment order (cells g, g + 8 x outputs 2t, 2t + 1), the sum over the
// k-steps of bf16(max(AB + CD, 0)) . bf16(W2); AB of the next k-step is
// loaded before the current one's products. ab_lo / ab_hi: AB at this
// thread's cells; cdr: the chunk's CD rows [ZC][HP] from row zl0.
template <int R>
__device__ __forceinline__ void fwd_group(const float* __restrict__ ab_lo, const float* __restrict__ ab_hi,
                                          size_t plane, const uint2* w2f, const float* cdr, int HP, int H,
                                          float (&acc)[R][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  const int nkb = (H + 15) >> 4, nfull = H >> 4;
  // AB at the thread's cells and hidden unit 16 kb + 2t
  const float* pl = ab_lo + (size_t)(2 * t) * plane;
  const float* ph = ab_hi + (size_t)(2 * t) * plane;
  float al[4], ah[4];
  mma16::ab_kstep(pl, plane, 2 * t, H, nfull > 0, al);
  mma16::ab_kstep(ph, plane, 2 * t, H, nfull > 0, ah);
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    float nl[4], nh[4];
    if (kb + 1 < nkb) {  // warp-uniform
      pl += 16 * plane, ph += 16 * plane;
      mma16::ab_kstep(pl, plane, 16 * (kb + 1) + 2 * t, H, kb + 1 < nfull, nl);
      mma16::ab_kstep(ph, plane, 16 * (kb + 1) + 2 * t, H, kb + 1 < nfull, nh);
    }
    const uint2 w = w2f[kb * 32 + lane];
    const int h0 = 16 * kb + 2 * t;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float2 c0 = *reinterpret_cast<const float2*>(cdr + i * HP + h0);
      const float2 c8 = *reinterpret_cast<const float2*>(cdr + i * HP + h0 + 8);
      mma16816(acc[i], relu2(al[0] + c0.x, al[1] + c0.y), relu2(ah[0] + c0.x, ah[1] + c0.y),
               relu2(al[2] + c8.x, al[3] + c8.y), relu2(ah[2] + c8.x, ah[3] + c8.y), w.x, w.y);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) al[j] = nl[j], ah[j] = nh[j];
  }
}

// What phase A reads and writes for one chunk.
struct FwdArgs {
  const float* ab;
  const float* tgt;
  const uint2* w2f;
  const float* cds;  // the chunk's CD rows [ZC][HP]
  uint32_t* gyw;     // the chunk's gy rows, as [ZC / 2][NT][4] uint32
  float* red;        // the chunk's loss sums [ZC][NW][2][2]
  const float* b2;
  int nx, ny, H, HP;
  float scale_sigma, scale_u;
};

// Phase A for the rows zl0 .. zl0 + R - 1 of fragment m (cells 16 m + g,
// + 8 of the warp's tile row): the group's target rows into registers
// (lanes t < 2: outputs 2t, 2t + 1), y, then e, gy (bf16 to the chunk's gy
// row pair, float32 into db2) and the squared errors, summed over the warp
// per (row, fragment) into red.
template <int ZC, int R>
__device__ __forceinline__ void fwd_rows(const FwdArgs& a, const mlph::Chunk& c, int m, int zl0, float (&db)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t plane = (size_t)a.nx * a.ny;
  const int gy = c.y0 + warp, x = c.x0 + 16 * m + g;  // the thread's cells x, x + 8 of tile row gy
  // (every lane loads, lanes t >= 2 and cells off the grid from a clamped
  // address, so that the loads need no branch; their values are not used)
  const size_t row = (size_t)min(gy, a.ny - 1) * a.nx;
  const int xc[2] = {min(x, a.nx - 1), min(x + 8, a.nx - 1)};
  float tg[R][2][2];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* tp = a.tgt + ((size_t)(c.z0 + zl0 + i) * 4 + 2 * (t & 1)) * plane + row + xc[half];
      tg[i][half][0] = __ldg(tp);
      tg[i][half][1] = __ldg(tp + plane);
    }
  float acc[R][4];
  fwd_group<R>(a.ab + row + xc[0], a.ab + row + xc[1], plane, a.w2f, a.cds + zl0 * a.HP, a.HP, a.H, acc);
  const bool valid[2] = {gy < a.ny && x < a.nx, gy < a.ny && x + 8 < a.nx};
  const int cell0 = warp * TX + 16 * m + g;  // the thread's cells in the tile: cell0, cell0 + 8
  const float bo0 = __ldg(a.b2 + 2 * (t & 1)), bo1 = __ldg(a.b2 + 2 * (t & 1) + 1);
  const float sc0 = t == 0 ? a.scale_sigma : a.scale_u;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int zl = zl0 + i;
    float sa = 0.f, sb = 0.f;
    if (t < 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float e0 = 0.f, e1 = 0.f;
        if (valid[half]) {
          e0 = (acc[i][2 * half] + bo0) - tg[i][half][0];
          e1 = (acc[i][2 * half + 1] + bo1) - tg[i][half][1];
        }
        if (t == 0) {
          sa += e0 * e0;
          sb += e1 * e1;
        } else {
          sb += e0 * e0 + e1 * e1;
        }
        const float g0 = sc0 * e0, g1 = a.scale_u * e1;
        db[0] += g0;
        db[1] += g1;
        a.gyw[((zl >> 1) * NT + cell0 + 8 * half) * 4 + 2 * (zl & 1) + t] = pack2(g0, g1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa = pat::add(sa, __shfl_down_sync(0xffffffffu, sa, off));
      sb = pat::add(sb, __shfl_down_sync(0xffffffffu, sb, off));
    }
    if (lane == 0) {
      a.red[((zl * NW + warp) * 2 + m) * 2] = sa;
      a.red[((zl * NW + warp) * 2 + m) * 2 + 1] = sb;
    }
  }
}

// Phase A of a chunk: both fragments of the warp's tile row, its rows in
// straight-line groups of 8, 4, 2 and 1 (no branch on the row count in the
// loop over the hidden units); an odd chunk's last row pair gets a zero
// second row (its da1 and dW2 products then add zeros).
template <int ZC>
__device__ __forceinline__ void forward(const FwdArgs& a, const mlph::Chunk& c, float (&db)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    int zl = 0;
    for (; c.n - zl >= RMAX; zl += RMAX) fwd_rows<ZC, RMAX>(a, c, m, zl, db);
    if (c.n - zl >= 4) fwd_rows<ZC, 4>(a, c, m, zl, db), zl += 4;
    if (c.n - zl >= 2) fwd_rows<ZC, 2>(a, c, m, zl, db), zl += 2;
    if (c.n - zl >= 1) fwd_rows<ZC, 1>(a, c, m, zl, db);
    if ((c.n & 1) && t < 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        a.gyw[((c.n >> 1) * NT + warp * TX + 16 * m + g + 8 * half) * 4 + 2 + t] = 0u;
    }
  }
}

// Phase B of a chunk for the warp's 16 hidden units h0 .. h0 + 15 (a
// thread: h0 + g and h0 + g + 8) over the tile's 256 cells, a tile row of
// 32 cells at a time (the thread's: 16 m + 2t + {0, 1, 8, 9}, m = 0, 1):
// AB and the dAB slot of the thread's cells in registers, then the chunk's
// rows by pairs (one ldmatrix and one ldmatrix.trans of the pair's gy rows;
// an odd chunk's last pair has a zero second row, whose products add
// zeros). Per row: da1^T = [W2 | 0] . gy (even row) or [0 | W2] . gy (odd
// row) by m16n8k8, the mask, dAB and dCD on its C fragments, dW2 +=
// bf16(a1) . gy by m16n8k16 into the row parity's accumulator; the row's
// dCD over the warp (shuffles), then over the tile rows in the warp's
// shared rows. cds: the chunk's CD rows [ZC][HP]; gyb: its gy rows
// [ZC / 2][NT]; slot: the block's dAB partial slot [H][NT] (`first`:
// store, else add to it); dcd_w: the warp's dCD rows [ZC][16], to
// dcd_part [nz][ntiles][H] at the end; dw_s [HP][4]: the chunk's dW2T
// added (the warp alone owns h0 .. h0 + 15 of both).
template <int ZC>
__device__ __forceinline__ void backward(const float* __restrict__ ab, const uint4* gyb, const float* cds,
                                         const float* __restrict__ w2t, float* __restrict__ slot,
                                         float* __restrict__ dcd_part, float* dcd_w, float* dw_s,
                                         const mlph::Chunk& c, bool first, int h0, int H, int HP, int nx, int ny,
                                         int ntiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t plane = (size_t)nx * ny;
  const int hr[2] = {h0 + g, h0 + g + 8};
  // da1's A operands: [W2 | 0] (even rows: lanes t < 2 hold W2[h][2t, 2t + 1])
  // and [0 | W2] (odd rows: lanes t >= 2 hold W2[h][2t - 4, 2t - 3]).
  uint32_t wa[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = 2 * (t & 1);
    auto w = [&](int oo) { return hr[r] < H ? __ldg(w2t + oo * H + hr[r]) : 0.f; };
    const uint32_t v = pack2(w(o), w(o + 1));
    wa[0][r] = t < 2 ? v : 0u;
    wa[1][r] = t < 2 ? 0u : v;
  }
  float dw[2][4];  // dW2's accumulator of each row parity
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int v = 0; v < 4; ++v) dw[e][v] = 0.f;
  // AB's and the slot's rows of the thread's hidden unit h0 + g (+ 8 at
  // ab8 and NT * 8 further; past H: not read)
  const float* abr = ab + (size_t)(hr[0] < H ? hr[0] : 0) * plane + (size_t)c.y0 * nx + c.x0;
  const size_t ab8 = 8 * plane;
  float* slr = slot + (size_t)(hr[0] < H ? hr[0] : 0) * NT;
  const int np = (c.n + 1) >> 1;
#pragma unroll 1
  for (int yl = 0; yl < mlph::TY; ++yl) {
    const int gy = c.y0 + yl;
    float a[2][2][4], dab[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lx = 16 * m + 2 * t + (i & 1) + 8 * (i >> 1);
        const bool valid = gy < ny && c.x0 + lx < nx;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool on = valid && hr[r] < H;
          a[r][m][i] = on ? __ldg(abr + r * ab8 + yl * nx + lx) : 0.f;
          dab[r][m][i] = on && !first ? slr[r * 8 * NT + yl * TX + lx] : 0.f;
        }
      }
#pragma unroll 1
    for (int p = 0; p < np; ++p) {
      // the pair's gy at the tile row's 32 cells (matrix j: cells 8 j ..)
      uint32_t bn[4], bt[4];
      ldsm4(bn, gyb + p * NT + yl * TX + lane);
      ldsm4_t(bt, gyb + p * NT + yl * TX + lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int zl = 2 * p + e;
        float cv[2], dc[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) cv[r] = cds[zl * HP + hr[r]];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // da1^T of the n8 tiles 2 m, 2 m + 1 (cells 16 m + 8 n ..): (h0 + g, + 8) x cells 2t, 2t + 1
          float d[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int v = 0; v < 4; ++v) d[n][v] = 0.f;
            mma1688(d[n], wa[e][0], wa[e][1], bn[2 * m + n]);
          }
          // Cell i of the thread is C element (i & 1) of n8 tile 2 m + (i >> 1).
          float pre[2][4];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              pre[r][i] = a[r][m][i] + cv[r];
              if (pre[r][i] > 0.f) {
                const float dz = d[i >> 1][2 * r + (i & 1)];
                dc[r] += dz;
                dab[r][m][i] += dz;
              }
            }
          // dW2 += a1^T gy over the 16 cells: A rows h (g, g + 8), columns
          // the cells 2t + {0, 1} (a0, a1) and 2t + 8 + {0, 1} (a2, a3).
          mma16816(dw[e], relu2(pre[0][0], pre[0][1]), relu2(pre[1][0], pre[1][1]), relu2(pre[0][2], pre[0][3]),
                   relu2(pre[1][2], pre[1][3]), bt[2 * m], bt[2 * m + 1]);
        }
        // dCD of the row: the 4 lanes of a hidden unit, then the warp's rows.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 1);
          dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 2);
        }
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* q = dcd_w + zl * 16 + g + 8 * r;
            *q = yl == 0 ? dc[r] : *q + dc[r];
          }
        }
      }
    }
    // ---- the tile row's dAB to the block's slot
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lx = 16 * m + 2 * t + (i & 1) + 8 * (i >> 1);
        if (gy < ny && c.x0 + lx < nx) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (hr[r] < H) slr[r * 8 * NT + yl * TX + lx] = dab[r][m][i];
        }
      }
  }
  // The rows' dCD leave from the lanes that summed them; dW2T: outputs 0-3
  // of the even rows' accumulator (lanes t < 2) and 4-7 of the odd rows'
  // (lanes t + 2).
  if (t == 0) {
    for (int zl = 0; zl < c.n; ++zl)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (hr[r] < H) dcd_part[((size_t)(c.z0 + zl) * ntiles + c.tile) * H + hr[r]] = dcd_w[zl * 16 + g + 8 * r];
  }
  float odd[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) odd[v] = __shfl_xor_sync(0xffffffffu, dw[1][v], 2);
  if (t < 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dw_s[hr[r] * 4 + 2 * t] += dw[0][2 * r] + odd[2 * r];
      dw_s[hr[r] * 4 + 2 * t + 1] += dw[0][2 * r + 1] + odd[2 * r + 1];
    }
  }
}

// K6 bf16 (see the file comment). Per chunk: the next chunk's CD rows are
// copied (cp.async) while A and B of this one run; two barriers a chunk.
template <int ZC>
__global__ void __launch_bounds__(NT, 2)
    k_fit_bf16(const float* __restrict__ ab, const float* __restrict__ cd, const float* __restrict__ w2t,
               const float* __restrict__ b2, const float* __restrict__ tgt, float* __restrict__ tile_parts,
               float* __restrict__ dab_part, float* __restrict__ dcd_part, float* __restrict__ dw2_part,
               float* __restrict__ db2_part, int nx, int ny, int nz, int H, float scale_sigma, float scale_u) {
  extern __shared__ float4 sh4[];
  char* sh = reinterpret_cast<char*>(sh4);
  const int HP = mma16::pad16(H);
  const Layout L = fit_layout(H, ZC);
  uint2* w2f = reinterpret_cast<uint2*>(sh + L.w2f);
  float* dw_s = reinterpret_cast<float*>(sh + L.dw);    // [HP][4]
  float* cd_s = reinterpret_cast<float*>(sh + L.cd);    // [2][ZC][HP]
  uint4* gy_s = reinterpret_cast<uint4*>(sh + L.gy);    // [ZC / 2][NT]
  float* dcd_w = reinterpret_cast<float*>(sh + L.dcd);  // [NW][ZC][16]
  float* red = reinterpret_cast<float*>(sh + L.red);    // [ZC][NW][2][2]
  __shared__ float red2[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + mlph::TY - 1) / mlph::TY);
  const int nrows = ntiles * nz;
  mma16::load_w2_frags<false>(w2f, w2t, H, HP);
  for (int i = tid; i < 4 * HP; i += NT) dw_s[i] = 0.f;
  for (int i = tid; i < 2 * ZC * HP; i += NT) cd_s[i] = 0.f;  // (its padding past H stays zero)
  float db[2] = {0.f, 0.f};  // db2 of outputs 2t, 2t + 1 (lanes t < 2)
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  float* dab_blk = dab_part + (size_t)blockIdx.x * H * NT;  // slot blk + tile
  __syncthreads();  // fit bf16: the zeroed CD rows before the first copy
  copy_cd<ZC>(cd_s, cd, mlph::chunk_at(r0, r1, ZC, nz, ntx), H, HP);
  mlph::wait_cd_rows();
  __syncthreads();  // fit bf16: W2's fragments, the zeroed sums, the first chunk's CD rows
  for (int r = r0, k = 0; r < r1; ++k) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZC, nz, ntx);
    float* cds = cd_s + (k & 1) * ZC * HP;
    if (r + c.n < r1)  // the next chunk's CD rows, while this one runs
      copy_cd<ZC>(cd_s + ((k + 1) & 1) * ZC * HP, cd, mlph::chunk_at(r + c.n, r1, ZC, nz, ntx), H, HP);
    forward<ZC>(FwdArgs{ab, tgt, w2f, cds, reinterpret_cast<uint32_t*>(gy_s), red, b2, nx, ny, H, HP, scale_sigma,
                        scale_u},
                c, db);
    __syncthreads();  // fit bf16: the chunk's gy rows and loss sums in
    if (tid < 2 * c.n) {  // the rows' loss tile partials, the warps in order
      const int zl = tid / 2, kk = tid % 2;
      float s = 0.f;
      for (int wi = 0; wi < 2 * NW; ++wi) s = pat::add(s, red[(zl * 2 * NW + wi) * 2 + kk]);
      tile_parts[((size_t)kk * nz + c.z0 + zl) * ntiles + c.tile] = s;
    }
    float* slot = dab_blk + (size_t)c.tile * H * NT;
    const bool first = r == r0 || c.z0 == 0;
    for (int hb = warp; 16 * hb < H; hb += NW)
      backward<ZC>(ab, gy_s, cds, w2t, slot, dcd_part, dcd_w + warp * ZC * 16, dw_s, c, first, 16 * hb, H, HP, nx,
                   ny, ntiles);
    mlph::wait_cd_rows();
    __syncthreads();  // fit bf16: the chunk's backward (gy, its CD rows and the loss sums free); the next CD rows in
    r += c.n;
  }

  // ---- the block's partials ----------------------------------------------
  const size_t blk = blockIdx.x;
  mlph::store_dw2(dw2_part + blk * 4 * H, dw_s, H);
  const int t = tid & 3;
  float d4[4] = {t == 0 ? db[0] : 0.f, t == 0 ? db[1] : 0.f, t == 1 ? db[0] : 0.f, t == 1 ? db[1] : 0.f};
  pat::block_sum2<NT>(d4[0], d4[1], red2);
  __syncthreads();  // fit bf16: red2 free again (db2)
  pat::block_sum2<NT>(d4[2], d4[3], red2);
  if (tid == 0) {
#pragma unroll
    for (int o = 0; o < 4; ++o) db2_part[blk * 4 + o] = d4[o];
  }
}

}  // namespace bfit

}  // namespace

// AB [H, ny, nx], CD [nz, H, 1], W2T [4, H], b2 [4], target [nz, 4, ny*nx];
// scratch: tile partials [2, nz, ntiles], dAB partials [nblk + ntiles - 1,
// H, 256], dCD partials [nz, ntiles, H], dW2T partials [nblk, 4, H], db2
// partials [nblk, 4]; outputs dAB [H, ny, nx], dCD [nz, H, 1], dW2T [4, H],
// db2 [4]. nblk = min(tile rows, NBLK) (the host computes it); the shared
// memory within a block's (the host gates).
namespace {

int check_grid(int nx, int ny, int nz, int H, int nblk, size_t smem) {
  const int nrows = ((nx + TX - 1) / TX) * ((ny + mlph::TY - 1) / mlph::TY) * nz;
  return H < 1 || nblk < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
         smem + 4 * 2 * NW > (size_t)mlph::SMEM_LIMIT;
}

}  // namespace

extern "C" int pat_fit(const float* ab, const float* cd, const float* w2t, const float* b2,
                       const float* tgt, float* tile_parts, float* dab_part, float* dcd_part,
                       float* dw2_part, float* db2_part, float* dab, float* dcd, float* dw2t,
                       float* db2, int nx, int ny, int nz, int H, int nblk, float scale_sigma,
                       float scale_u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = fit_smem_bytes(H);
  if (check_grid(nx, ny, nz, H, nblk, smem + 4 * 2 * NW * ZC)) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k_fit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_fit<<<nblk, NT, smem, s>>>(ab, cd, w2t, b2, tgt, tile_parts, dab_part, dcd_part, dw2_part, db2_part, nx, ny,
                               nz, H, scale_sigma, scale_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mlph::launch_sums<1>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2, nx, ny, nz, H,
                                   nblk, s);
}

// The bf16 tier: the same arguments.
extern "C" int pat_fit_bf16(const float* ab, const float* cd, const float* w2t, const float* b2,
                            const float* tgt, float* tile_parts, float* dab_part, float* dcd_part,
                            float* dw2_part, float* db2_part, float* dab, float* dcd, float* dw2t,
                            float* db2, int nx, int ny, int nz, int H, int nblk, float scale_sigma,
                            float scale_u, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int zc = bfit::fit_zc(H);
  const size_t smem = bfit::fit_layout(H, zc).total;
  if (check_grid(nx, ny, nz, H, nblk, smem)) return (int)cudaErrorInvalidValue;
  auto kern = zc == 24   ? bfit::k_fit_bf16<24>
              : zc == 16 ? bfit::k_fit_bf16<16>
              : zc == 8  ? bfit::k_fit_bf16<8>
                         : bfit::k_fit_bf16<4>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<nblk, NT, smem, s>>>(ab, cd, w2t, b2, tgt, tile_parts, dab_part, dcd_part, dw2_part, db2_part, nx, ny,
                              nz, H, scale_sigma, scale_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mlph::launch_sums<1>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2, nx, ny, nz, H,
                                   nblk, s);
}
