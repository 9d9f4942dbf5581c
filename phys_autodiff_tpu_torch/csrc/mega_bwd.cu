// K4: the backward mega-kernel (the loss and every MLP table gradient), sm_90a.
//
// Replaces _build_bwd_call of phys_autodiff_tpu/pallas/mega_bwd.py (:568).
// From the folded tables of K2 / K3 (AB [H, ny, nx], CD [nz, H, 3],
// W2T [4, H], b2 [4]) it computes the per-(z plane, tile) loss partials and
// dAB, dCD, dW2T, db2; the host pulls those back through the folds to
// (W1, b1, W2, b2, t).
//
// Separate passes, as K5 runs them, and no float atomics: every sum has a
// fixed order, so the gradients are the same bits from run to run. Passes 1
// and 3 run on the tiled MLP core of mlp_head.cuh (shared with K6), on a
// persistent grid of min(tile rows, 264) blocks, each walking a contiguous
// range of 32 x 8 tile rows in chunks of rows of one tile.
//   1. k_bwd_fields: the core's forward routine (mlp_head.cuh fwd_chunk,
//      shared with K2 and K3), thread per cell, ZF = 4 rows a chunk (AB
//      read once for them; W2 and the CD rows as float4 broadcasts; a short
//      chunk runs groups of 2 and 1 rows; ZF = 6 ran slower): the three
//      slices' y_s = W2T relu(AB + CD[z, :, s]) + b2 through a channel map
//      to fbuf [12, nz, ny, nx] (t slice first, so fbuf[0:4] is the
//      [4, nz, ny, nx] the adjoint reads; t-dt 4..7, t+dt 8..11). No x/y
//      halo and no extra z row is evaluated: every field value once, with
//      the bits K2 gives it. 8 KB of shared memory at H = 128.
//   2. k_residuals<MODE_SCALED_PARTIALS> (residuals.cuh, K1's body): the
//      loss tile partials and g = (2w/N) R [4, nz, ny, nx].
//   3. k_bwd_adjoint, ZC = 8 rows a chunk (the f32 tier's; bf16 below):
//      A  thread per cell: the stencil adjoint (adjoint.cuh, gather form)
//         gives the t-slice cotangents dF; those of t -+ dt are -+ g/(2dt).
//         dF and g/(2dt) go to shared memory.
//      B  the core's backward for three slices: a warp per pair of hidden
//         units, a lane per tile column (8 cells), the chunk's rows inner;
//         with gy_tm1 = -g/(2dt), gy_t = dF, gy_tp1 = +g/(2dt),
//           dz1_s = [AB + CD_s > 0] (W2 gy_s),  dAB += dz1_t + (dz1_tm1 +
//           dz1_tp1),  dCD_s += dz1_s,  dW2T += relu(z1_t) dF +
//           (relu(z1_tp1) - relu(z1_tm1)) g/(2dt)
//         (the t -+ dt legs are 1/(2 dt) times larger than the t slice's
//         and nearly cancel, so they meet per cell first). dAB leaves the
//         block once a (block, tile), dCD once a row, dW2T once a block.
//      Shared memory: dF and g/(2dt) [ZC][256] (64 KB), the CD rows
//      [ZC][HP][3], W2 [HP] float4 and the dW2T sums [HP][4]: 64 KB + 128 HP
//      bytes (80 KB at H = 128, two blocks an SM); H reaches 1,300.
//   4. k_bwd_finalize<3>, k_bwd_reduce (mlp_head.cuh): dAB over the blocks
//      of each tile, dCD over tiles, dW2T and db2 over blocks.
//
// Bound on this card: FP32 operations, an FMA counted as two. The three
// slices' forward costs about 30 operations per (cell, hidden unit) and the
// backward about 46; with the residual and its adjoint (about 316 a cell)
// that is 11.8 GFLOP at H = 128 on 128x96x96, 0.177 ms at 67 TFLOP/s
// (chip_smoke.py's work table). The memory traffic is small beside that:
// the fields and g (75 MB written, read back through L2), the dAB partials
// (41 MB at the flagship) and AB (read once a chunk, from L2). The passes
// run FFMA on the CUDA cores in the f32 tier (W2 has 4 columns; the bf16
// tier below takes the tensor cores all the same, half of n = 8 idle).
//
// The bf16 tier (pat_mega_bwd_bf16; k_bwd_fields<true, RING>, k_bwd_adjoint_bf16):
// the same passes with layer 2's three contractions on the tensor cores
// (mlp_mma.cuh), every operand rounded to bf16 and float32 sums, as the TPU's
// bf16 tier (pallas/mega_bwd.py:633-634, 705-750): pass 1 is K2's bf16
// forward (fields_chunk, AB through the warps' rings as deep as
// mma16::ring_stages allows beside its 96 HP bytes), so the loss is K2
// bf16 -> K1's to the bit. Pass 3
// walks the block's chunks with one barrier a chunk:
//   A (thread per cell) writes the chunk's cotangents once, as one 16-byte
//     bf16 row a cell [dF | g/(2dt)], double-buffered: A of chunk c + 1 runs
//     in the interval of B of chunk c, a row at the top of each of the 8
//     tile rows of a warp's first 16 hidden units, so the stencil adjoint's
//     L2 gathers meet other warps' products instead of a barrier. A row is
//     a function of its own (stage_a_row, not inlined) and each thread's
//     db2 sums sit in shared memory: with the stencil adjoint inlined into
//     B's loop the pass spilled registers.
//   B: a warp per 16 hidden units, a lane per pair of tile-row cells, the
//     chunk's rows inner (AB and the block's dAB slot read once a tile row
//     and chunk, the CD rows and AB through L1: streaming AB and the slot
//     past L1 was slower). da1 of both legs from the one row
//     layout: ldmatrix gives the B fragment and A = [W2 | 0], [0 | W2]
//     (m16n8k8); B1 on the C fragments with the masks [AB + CD_s > 0] as
//     0 / 1 floats (dz1_tm1 + dz1_tp1 = q (m_tp1 - m_tm1): the -+ q legs
//     cancel exactly; 16 CUDA-core operations a (cell, hidden unit)
//     against about 20); dW2 by m16n8k8 a 8-cell tile, B from ldmatrix.trans
//     of the same rows (a1_t . [dF | 0] into columns 0..3, a1_tp1 . [0 | q]
//     and a1_tm1 . [0 | -q] into 4..7 of a second accumulator, the legs
//     added at the tile row's end); the dCD sums of two lanes meet by one
//     shuffle and are added in the warp's shared rows, two slots a hidden
//     unit.
// Per (cell, hidden unit) the CUDA cores keep about 16 operations of the
// backward and 6 of the forward; with the residual and its adjoint the
// function's count stays 22.5 H + 316 a cell: 0.057 ms at H = 128 on
// 128x96x96 at 67 TFLOP/s, against 128 H a cell of tensor-core FLOP as
// issued (0.020 ms at 989 TFLOP/s; chip_smoke.py's work table). The pass
// is not issue-bound: cutting its instructions a pair did not make it
// faster, its warps wait, and the card's toolkit gives no stall reasons
// (PERF.md §6). Shared memory of pass 3: the cotangents of two chunks
// (64 KB), the dW2T sums, the warps' dCD rows (24 KB) and the threads'
// db2 sums (4 KB): 94 KB at H = 128, two blocks an SM; the host gates
// H <= 1360.
//
// The clamp z edge at nz = 1: the forward z difference is identically 0
// there, so its adjoint is 0. The gather form of adjoint.cuh gives exactly
// that; the TPU kernel's edge legs do not (ROADMAP.md Queue C, R4).
//
// The shard-local build (_build_bwd_call(nz_local=...), pallas/mega_bwd.py:
// 568-800): z0 and nz_local pick the rows [z0, z0 + nz_local) of the global
// nz that the call owns (pat::ZRows). Pass 1 computes the fields of the
// global rows z0 - 2 .. z0 + nz_local + 1, wrapped or clamped on the global
// grid (load_cd_rows maps each buffer row's CD row); pass 2 runs K1's body
// on those nz_local + 4 rows, so the residual rows z0 - 1 .. z0 + nz_local
// that a neighbour owns are recomputed here and never read off the
// neighbour; pass 3 walks the owned rows only, each gathering its
// cotangent from the residual rows beside it, with the clamp edges keyed
// on the global row. Every field row's cotangent is computed once, by its
// owner, so the shards' dAB, dW2T and db2 add up to the whole grid's, and
// dCD comes out for the owned rows. The scratch is sized for nz_local + 4
// rows; the whole grid (z0 = 0, nz_local = nz) keeps its own frame and its
// bits.

#include "adjoint.cuh"
#include "mlp_mma.cuh"
#include "residuals.cuh"

namespace {

using mlph::NW;
constexpr int ZF = 4;  // rows of a chunk of the fields pass
constexpr int ZC = 8;  // rows of a chunk of the adjoint pass (kernels/mega_bwd.py ZROWS)

// Dynamic shared memory (bytes) of the fields pass (W2 [HP] float4, the CD
// rows [HP][ZF][3]) and of the adjoint pass (dF and g/(2dt), the CD rows, W2,
// the dW2T sums).
__host__ __device__ inline size_t fields_smem_bytes(int H) {
  return (size_t)(4 + ZF * 3) * mlph::pad4(H) * sizeof(float);
}
__host__ __device__ inline size_t adjoint_smem_bytes(int H) {
  const int HP = mlph::pad4(H);
  return (size_t)ZC * NT * 2 * sizeof(float4) + ((size_t)ZC * HP * 3 + 8 * (size_t)HP) * sizeof(float);
}
// The bf16 tier's: the fields pass W2's B fragments and the CD rows
// [HP][ZF][4]; the adjoint pass the cotangents [dF | g/(2dt)] in bf16, 16
// bytes a cell, of two chunks ([2][ZC][NT] uint4: the one B reads, the one
// A writes), the dW2T sums [HP][4], each warp's dCD rows [ZC][3][16][2]
// (two lanes' partials a hidden unit) and each thread's db2 sums [NT]
// float4; HP padded to 16.
__host__ __device__ inline size_t fields_smem_bf16(int H) {
  return (size_t)(4 + (ZF + 1) * 4) * mma16::pad16(H) * sizeof(float);
}
constexpr size_t GY2_BYTES = (size_t)2 * ZC * NT * 16;
__host__ __device__ inline size_t adjoint_smem_bf16(int H) {
  return GY2_BYTES + 4 * (size_t)mma16::pad16(H) * sizeof(float) + (size_t)NW * ZC * 3 * 16 * 2 * sizeof(float) +
         NT * sizeof(float4);
}

// Pass 1: the fields of the three slices (see the file comment); BF16: on
// the tensor cores (mlp_mma.cuh fields_chunk, K2's bf16 routine).
template <bool BF16, bool RING>
__global__ void __launch_bounds__(NT, 2)
    k_bwd_fields(const float* __restrict__ ab, const float* __restrict__ cd,
                 const float* __restrict__ w2t, const float* __restrict__ b2, mlph::Chans out, int nx,
                 int ny, pat::ZRows zr, int periodic, int H) {
  constexpr int P = BF16 ? 4 : 3, NROW = BF16 ? ZF + 1 : ZF;  // bf16: one padding row (fields_chunk)
  extern __shared__ float4 sh4[];
  const int HP = BF16 ? mma16::pad16(H) : mlph::pad4(H);
  float4* w2_s = sh4;                                  // [HP] (bf16: W2's B fragments [2 HP] uint2)
  float* cd_s = reinterpret_cast<float*>(sh4 + HP);    // [HP][NROW][P]
  float* ring_s = cd_s + (size_t)HP * NROW * P;        // bf16: [NW][FW_NS][FW_STAGE], the warps' AB rings
  // the buffer rows: local rows and their halo rows (pat::ZRows); row b
  // holds global row z0 - hz + b, wrapped or clamped (load_cd_rows maps it;
  // zr's values read where they are used keep the registers free)
  const int ntx = (nx + TX - 1) / TX, nrows = ntx * ((ny + TY - 1) / TY) * zr.nb();
  if constexpr (BF16) {
    mma16::load_w2_frags<false>(reinterpret_cast<uint2*>(sh4), w2t, H, HP);
    mma16::set_chans(out);
  } else {
    mlph::load_w2(w2_s, w2t, H, HP);
  }
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZF, zr.nb(), ntx);
    __syncthreads();  // fields: the last chunk done with cd_s
    mma16::AbRing ring;
    if constexpr (BF16) {
      ring = mma16::ring_start<RING>(ring_s, ab, c, nx, ny, H);
      mma16::publish_chunk(c);
    }
    mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zr.z0 - zr.hz + c.z0, c.n, zr.nz, periodic, H, HP);
    __syncthreads();  // fields: the chunk's CD rows in
    if constexpr (BF16) {
      mma16::fields_chunk<3, ZF, P, false, RING>(ring, cd_s, reinterpret_cast<const uint2*>(sh4), nullptr, b2,
                                                 mma16::fw_chunk, nx, ny);
      r += mma16::fw_chunk.n;
    } else {
      mlph::fields_chunk<3, ZF>(ab, cd_s, w2_s, b2r, out, c, nx, ny, H);
      r += c.n;
    }
  }
}

// Pass 3 of the f32 tier (see the file comment).
__global__ void __launch_bounds__(NT, 2)
    k_bwd_adjoint(const float* __restrict__ ab, const float* __restrict__ cd,
                  const float* __restrict__ w2t, const float* __restrict__ fbuf,
                  const float* __restrict__ gbuf, float* __restrict__ dab_part,
                  float* __restrict__ dcd_part, float* __restrict__ dw2_part,
                  float* __restrict__ db2_part, int nx, int ny, pat::ZRows zr, int H, int periodic,
                  pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  const int HP = mlph::pad4(H);
  float4* gy_s = sh4;                                  // [ZC][NT][2]: dF, g / (2dt)
  float4* w2_s = sh4 + ZC * NT * 2;                    // [HP]
  float* cd_s = reinterpret_cast<float*>(w2_s + HP);   // [ZC][HP][3]
  float* dw_s = cd_s + ZC * HP * 3;                    // [HP][4]
  __shared__ float red[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5;
  // the walk covers the owned rows (local z); their CD rows start at z0
  const int nz = zr.n;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  const float* cd_own = cd + (size_t)zr.z0 * H * 3;
  mlph::load_w2(w2_s, w2t, H, HP);
  for (int i = tid; i < 4 * HP; i += NT) dw_s[i] = 0.f;
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  float* dab_blk = dab_part + (size_t)blockIdx.x * H * NT;  // slot blk + tile

  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZC, nz, ntx);
    // the block's first chunk of a tile starts its dAB slot (a local test:
    // a shard's walk starts each tile at its local row 0)
    const bool first = r == r0 || c.z0 == 0;
    __syncthreads();  // adjoint: the last chunk's B done with gy_s and cd_s
    mlph::load_cd<3>(cd_s, cd_own, c.z0, c.n, ZC, H, HP);

    // ---- A: field cotangents of every cell of the chunk ------------------
    const int gx = c.x0 + tid % TX, gy = c.y0 + tid / TX;
    for (int zl = 0; zl < c.n; ++zl) {
      float4 df = make_float4(0.f, 0.f, 0.f, 0.f), gq = df;
      if (gx < nx && gy < ny) {
        float d[4], gc[4];
        pat::t_slice_adjoint(fbuf, gbuf, gx, gy, c.z0 + zl, nx, ny, zr, periodic, k, d, gc);
        df = make_float4(d[0], d[1], d[2], d[3]);
        gq = make_float4(k.inv2dt * gc[0], k.inv2dt * gc[1], k.inv2dt * gc[2], k.inv2dt * gc[3]);
#pragma unroll
        for (int o = 0; o < 4; ++o) db[o] += d[o];
      }
      gy_s[(zl * NT + tid) * 2] = df;
      gy_s[(zl * NT + tid) * 2 + 1] = gq;
    }
    __syncthreads();  // adjoint: A done (gy_s and the CD rows in)

    // ---- B: the backward of the chunk on the core ---------------------------
    float* slot = dab_blk + (size_t)c.tile * H * NT;
    for (int hp = warp; 2 * hp < H; hp += NW)
      mlph::bwd_item<3>(ab, gy_s, cd_s, w2_s, slot, dcd_part, dw_s, c, first, 2 * hp, H, HP, nx, ny, ntiles);
    r += c.n;
  }
  __syncthreads();  // adjoint: the last B (dw_s complete)

  // ---- the block's partials ----------------------------------------------
  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  const size_t blk = blockIdx.x;
  mlph::store_dw2(dw2_part + blk * 4 * H, dw_s, H);
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();  // adjoint: red free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int o = 0; o < 4; ++o) db2_part[blk * 4 + o] = db[o];
  }
}

// A row of the cotangents (see k_bwd_adjoint_bf16's stage_a), not inlined
// so that the stencil adjoint's registers do not add to B's.
__device__ __noinline__ void stage_a_row(const float* __restrict__ fbuf, const float* __restrict__ gbuf, uint4* gy2,
                                         float4* db_s, int x0, int y0, int z, int nx, int ny, pat::ZRows zr,
                                         int periodic, pat::StencilConsts k, int at) {
  const int tid = threadIdx.x, gx = x0 + tid % TX, gyy = y0 + tid / TX;
  float d[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  if (gx < nx && gyy < ny) {
    float gc[4];
    pat::t_slice_adjoint(fbuf, gbuf, gx, gyy, z, nx, ny, zr, periodic, k, d, gc);
#pragma unroll
    for (int o = 0; o < 4; ++o) q[o] = k.inv2dt * gc[o];
    const float4 v = db_s[tid];
    db_s[tid] = make_float4(v.x + d[0], v.y + d[1], v.z + d[2], v.w + d[3]);
  }
  gy2[at + tid] = make_uint4(mma16::pack2(d[0], d[1]), mma16::pack2(d[2], d[3]), mma16::pack2(q[0], q[1]),
                             mma16::pack2(q[2], q[3]));
}

// Pass 3 of the bf16 tier (see the file comment): the walk over the block's
// chunks, one barrier a chunk; the interval of chunk c runs B of c beside A
// of chunk c + 1 (cotangents double-buffered). A's rows are taken one at the
// top of each tile row of a warp's first m-tile (so their L2 gathers meet
// the products of the other warps), or alone by a warp without one.
__global__ void __launch_bounds__(NT, 2)
    k_bwd_adjoint_bf16(const float* __restrict__ ab, const float* __restrict__ cd,
                       const float* __restrict__ w2t, const float* __restrict__ fbuf,
                       const float* __restrict__ gbuf, float* __restrict__ dab_part,
                       float* __restrict__ dcd_part, float* __restrict__ dw2_part,
                       float* __restrict__ db2_part, int nx, int ny, pat::ZRows zr, int H, int periodic,
                       pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  const int HP = mma16::pad16(H);
  uint4* gy2 = reinterpret_cast<uint4*>(sh4);  // [2][ZC][NT]: dF (o 0..3), g / (2dt) (o 0..3), bf16
  float* dw_s = reinterpret_cast<float*>(reinterpret_cast<char*>(sh4) + GY2_BYTES);  // [HP][4]
  float* dcd_w = dw_s + 4 * HP;                                                      // [NW][ZC][3][16][2]
  float4* db_s = reinterpret_cast<float4*>(dcd_w + NW * ZC * 3 * 16 * 2);            // [NT]: db2 of the thread's cells
  __shared__ float red[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the walk covers the owned rows (local z); their CD rows start at z0
  const int nz = zr.n;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  const size_t plane = (size_t)nx * ny;
  const float* cd_own = cd + (size_t)zr.z0 * H * 3;
  for (int i = tid; i < 4 * HP; i += NT) dw_s[i] = 0.f;
  db_s[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  float* dab_blk = dab_part + (size_t)blockIdx.x * H * NT;  // slot blk + tile

  // ---- A: the cotangents of row zl of chunk c to buffer b, thread per cell:
  // dF (the stencil adjoint, adjoint.cuh) and q = g / (2dt) (those of t -+ dt
  // are -+ q), in bf16 as one row [dF | q] a cell --------------------------
  auto stage_a = [&](const mlph::Chunk& c, int b, int zl) {
    stage_a_row(fbuf, gbuf, gy2, db_s, c.x0, c.y0, c.z0 + zl, nx, ny, zr, periodic, k, (b * ZC + zl) * NT);
  };

  // ---- B: the backward of chunk c (cotangents in buffer b) for the warp's
  // 16 hidden units h0 .. h0 + 15 over the tile's 8 rows of 32 cells, the
  // chunk's rows inner; next / na: A's rows of the next chunk to take at
  // the top of tile rows 0 .. na - 1 ------------------------------------------
  auto tile_b = [&](const mlph::Chunk& c, int b, bool first, int h0, const mlph::Chunk& next, int nb, int na) {
    const int hr[2] = {h0 + g, h0 + g + 8};
    // da1's A fragments [W2 | 0] (pt) and [0 | W2] (pq), m16n8k8: rows h,
    // columns 2t, 2t + 1 of [dF | q]
    uint32_t wpt[2], wpq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool on = hr[r] < H;
      const int o = 2 * (t & 1);
      const uint32_t w = on ? mma16::pack2(__ldg(w2t + o * H + hr[r]), __ldg(w2t + (o + 1) * H + hr[r])) : 0u;
      wpt[r] = t < 2 ? w : 0u;
      wpq[r] = t < 2 ? 0u : w;
    }
    float* dcw = dcd_w + warp * ZC * 3 * 16 * 2;   // [ZC][3][16][2]: lanes t >> 1
    float* slot = dab_blk + (size_t)c.tile * H * NT;  // the block's dAB partial of the tile [H][NT]
    // the CD rows of the thread's hidden units (a padding unit reads the
    // last real one: its products meet zero weights) and the shared address
    // of the chunk's cotangents at this lane's ldmatrix row
    int cdr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) cdr[r] = (c.z0 * H + min(hr[r], H - 1)) * 3;
    const unsigned gy_sa = (unsigned)__cvta_generic_to_shared(gy2 + b * ZC * NT + (lane & 15));
#pragma unroll 1
    for (int yl = 0; yl < TY; ++yl) {
      // ---- tile row yl: A's row of the next chunk, then B
      if (yl < na) stage_a(next, nb, yl);
      const int gy = c.y0 + yl;
      // dW2T's C fragments of the tile row: dw's columns 0..3 (lanes t < 2)
      // the dF leg (a1_t . dF, outputs 2t, 2t + 1), dwq's columns 4..7
      // (lanes t + 2) the q legs (a1_tp1 . q - a1_tm1 . q, the same outputs)
      float dw[4] = {0.f, 0.f, 0.f, 0.f}, dwq[4] = {0.f, 0.f, 0.f, 0.f};
      // The thread's cells of tile row yl: x = 16 m + 2t + {0, 1, 8, 9}.
      float a[2][2][4], dab[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lx = 16 * m + 2 * t + (i & 1) + 8 * (i >> 1), x = c.x0 + lx;
          const bool valid = gy < ny && x < nx;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool on = valid && hr[r] < H;
            a[r][m][i] = on ? __ldg(ab + hr[r] * plane + (size_t)gy * nx + x) : 0.f;
            dab[r][m][i] = on && !first ? slot[(size_t)hr[r] * NT + yl * TX + lx] : 0.f;
          }
        }
#pragma unroll 1
      for (int zl = 0; zl < c.n; ++zl) {
        float cv[2][3];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int s = 0; s < 3; ++s) cv[r][s] = __ldg(cd_own + cdr[r] + zl * H * 3 + s);
        float dc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // [dF | q] of the 16 cells yl * TX + 16 m ..: da1's B (k: the 8
          // values, n: cells) and, .trans, dW2's (k: cells, n: the values)
          uint32_t gb[2], gk[2];
          const unsigned at = gy_sa + (zl * NT + yl * TX + 16 * m) * 16;
          mma16::ldsm2_at(gb, at);
          mma16::ldsm2_t_at(gk, at);
          // Per n8 tile ip (cells 8 ip + 2t + j of the 16): da1 of both legs,
          // B1 on its C fragments, then dW2T += bf16(a1_s) . bf16(gy_s) over
          // its 8 cells (m16n8k8): a1_t . [dF | q] into dw (columns 0..3
          // kept), a1_tp1 . [dF | q] and a1_tm1 . [-dF | -q] into dwq
          // (columns 4..7 kept). Cell i = 2 ip + j of the thread is C element
          // j of the tile, row r; the masks [a1_s > 0] from the float32 a1_s
          // = AB + CD_s as 0 / 1, dz1_tm1 + dz1_tp1 = q ([a1_tp1 > 0] -
          // [a1_tm1 > 0]) (the -+ q legs cancel exactly), dz1_t = [a1_t > 0] pt.
#pragma unroll
          for (int ip = 0; ip < 2; ++ip) {
            float pt[4] = {0.f, 0.f, 0.f, 0.f}, pq[4] = {0.f, 0.f, 0.f, 0.f};
            mma16::mma1688(pt, wpt[0], wpt[1], gb[ip]);
            mma16::mma1688(pq, wpq[0], wpq[1], gb[ip]);
            uint32_t act[3][2];  // bf16 relu(a1_s) as dW2's A fragment: rows g + 8 r, cells 8 ip + 2t..
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x[3][2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int i = 2 * ip + j, e = 2 * r + j;
#pragma unroll
                for (int s = 0; s < 3; ++s) x[s][j] = a[r][m][i] + cv[r][s];
                const float fm = x[0][j] > 0.f ? 1.f : 0.f, ft = x[1][j] > 0.f ? 1.f : 0.f;
                const float fp = x[2][j] > 0.f ? 1.f : 0.f;
                const float dmp = pq[e] * (fp - fm);
                dab[r][m][i] += fmaf(pt[e], ft, dmp);
                dc[r][0] = fmaf(-pq[e], fm, dc[r][0]);
                dc[r][1] = fmaf(pt[e], ft, dc[r][1]);
                dc[r][2] = fmaf(pq[e], fp, dc[r][2]);
              }
#pragma unroll
              for (int s = 0; s < 3; ++s) act[s][r] = mma16::relu2(x[s][0], x[s][1]);
            }
            mma16::mma1688(dw, act[1][0], act[1][1], gk[ip]);
            mma16::mma1688(dwq, act[2][0], act[2][1], gk[ip]);
            mma16::mma1688(dwq, act[0][0], act[0][1], gk[ip] ^ 0x80008000u);
          }
        }
        // dCD of the row: lanes t, t ^ 1 added, then each lane adds its
        // three sums (row r = t & 1) to its own slot (t >> 1) of the warp's rows
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int s = 0; s < 3; ++s) dc[r][s] += __shfl_xor_sync(0xffffffffu, dc[r][s], 1);
        const int rr = t & 1;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          float* p = dcw + ((zl * 3 + s) * 16 + g + 8 * rr) * 2 + (t >> 1);
          const float v = rr == 0 ? dc[0][s] : dc[1][s];
          *p = yl == 0 ? v : *p + v;
        }
      }
      // ---- the tile row's dAB partials to the block's slot
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lx = 16 * m + 2 * t + (i & 1) + 8 * (i >> 1);
          if (gy < ny && c.x0 + lx < nx) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (hr[r] < H) slot[(size_t)hr[r] * NT + yl * TX + lx] = dab[r][m][i];
          }
        }
      // the tile row's dW2T (the two legs added) to the block's sums
      float o4[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        dw[v] = t < 2 ? dw[v] : dwq[v];
        o4[v] = __shfl_down_sync(0xffffffffu, dw[v], 2);
      }
      if (t < 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dw_s[hr[r] * 4 + 2 * t] += dw[2 * r] + o4[2 * r];
          dw_s[hr[r] * 4 + 2 * t + 1] += dw[2 * r + 1] + o4[2 * r + 1];
        }
      }
    }
    // The rows' dCD (the two slots of a hidden unit added) leave the warp.
    __syncwarp();
    for (int i = lane; i < c.n * 3 * 16; i += 32) {
      const int zl = i / 48, s = (i / 16) % 3, hh = i % 16, h = h0 + hh;
      if (h < H)
        dcd_part[(((size_t)(c.z0 + zl) * ntiles + c.tile) * H + h) * 3 + s] =
            dcw[((zl * 3 + s) * 16 + hh) * 2] + dcw[((zl * 3 + s) * 16 + hh) * 2 + 1];
    }
    __syncwarp();
  };

  // the first chunk's A alone, then one interval a chunk
  int b = 0;
  if (r0 < r1) {
    const mlph::Chunk c = mlph::chunk_at(r0, r1, ZC, nz, ntx);
    for (int zl = 0; zl < c.n; ++zl) stage_a(c, 0, zl);
  }
  __syncthreads();  // adjoint bf16: the first chunk's A
  for (int r = r0; r < r1; b ^= 1) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZC, nz, ntx);
    // the block's first chunk of a tile starts its dAB slot (a local test:
    // a shard's walk starts each tile at its local row 0)
    const bool first = r == r0 || c.z0 == 0;
    const int rn = r + c.n;
    const mlph::Chunk next = mlph::chunk_at(rn < r1 ? rn : r, r1, ZC, nz, ntx);
    const int na = rn < r1 ? next.n : 0;
    if (16 * warp < H) {
      for (int hb = warp; 16 * hb < H; hb += NW) tile_b(c, b, first, 16 * hb, next, b ^ 1, hb == warp ? na : 0);
    } else {
      for (int zl = 0; zl < na; ++zl) stage_a(next, b ^ 1, zl);
    }
    __syncthreads();  // adjoint bf16: B of the chunk, A of the next
    r = rn;
  }

  // ---- the block's partials ----------------------------------------------
  // db2: the t -+ dt cotangents cancel, so db2 sums dF_t alone.
  const size_t blk = blockIdx.x;
  mlph::store_dw2(dw2_part + blk * 4 * H, dw_s, H);
  const float4 dbv = db_s[tid];
  float db[4] = {dbv.x, dbv.y, dbv.z, dbv.w};
  pat::block_sum2<NT>(db[0], db[1], red);
  __syncthreads();  // adjoint bf16: red free again (db2)
  pat::block_sum2<NT>(db[2], db[3], red);
  if (tid == 0) {
#pragma unroll
    for (int o = 0; o < 4; ++o) db2_part[blk * 4 + o] = db[o];
  }
}

}  // namespace

// AB [H, ny, nx], CD [nz, H, 3], W2T [4, H], b2 [4]; the rows [z0, z0 +
// nz_local) of the global nz (the whole grid: z0 = 0, nz_local = nz; else
// a shard's, with NB = nz_local + 4 buffer rows, pat::ZRows); scratch: tile
// partials [2, NB, ntiles], g [4, NB ny nx], the fields [12, NB ny nx], dAB
// partials [nblk + ntiles - 1, H, 256], dCD partials [nz_local, ntiles, H,
// 3], dW2T partials [nblk, 4, H], db2 partials [nblk, 4]; outputs dAB [H,
// ny, nx], dCD [nz_local, H, 3] (the owned rows), dW2T [4, H], db2 [4] (a
// shard's: its part of the sums). nblk = min(ntiles nz_local, NBLK) (the
// host computes it); the adjoint pass's shared memory within a block's (the
// host gates).
namespace {

template <bool BF16>
int launch(const float* ab, const float* cd, const float* w2t, const float* b2, float* tile_parts, float* gbuf,
           float* fbuf, float* dab_part, float* dcd_part, float* dw2_part, float* db2_part, float* dab, float* dcd,
           float* dw2t, float* db2, int nx, int ny, int nz, int z0, int nz_local, int H, int nblk,
           int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy, float inv2hz, float scale_sigma,
           float scale_u, void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  cudaStream_t s = (cudaStream_t)stream;
  // the whole grid (hz = 0), or a shard's rows with two halo rows a side
  const pat::ZRows zr{z0, nz_local, nz, nz_local == nz ? 0 : 2};
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz_local;
  const size_t fixed1 = BF16 ? fields_smem_bf16(H) : fields_smem_bytes(H);
  const int ns = BF16 ? mma16::ring_stages(fixed1, nx, ab) : 0;  // the fields pass's AB rings (mlp_mma.cuh)
  const size_t smem1 = fixed1 + mma16::ring_bytes(ns);
  const size_t smem3 = BF16 ? adjoint_smem_bf16(H) : adjoint_smem_bytes(H);
  const int nb = zr.nb();
  const size_t ncell = (size_t)nb * ny * nx;
  if (H < 1 || nblk < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
      smem3 + 4 * 2 * NW > (size_t)mlph::SMEM_LIMIT ||
      smem1 + (BF16 ? mma16::FW_STATIC : 0) > (size_t)mlph::SMEM_LIMIT || nz_local < 1 || z0 < 0 ||
      z0 + nz_local > nz ||
      (zr.hz == 0 && z0 != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  auto fields = BF16 && ns ? k_bwd_fields<BF16, BF16> : k_bwd_fields<BF16, false>;
  cudaFuncSetAttribute(fields, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  // fbuf's channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11 ([sigma, u]).
  mlph::Chans out;
  const int slot[3] = {4, 0, 8};
  for (int k = 0; k < 3; ++k)
    for (int o = 0; o < 4; ++o) out.p[k * 4 + o] = fbuf + (slot[k] + o) * ncell;
  fields<<<nblk, NT, smem1, s>>>(ab, cd, w2t, b2, out, nx, ny, zr, periodic, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // K1's channel order (PACKED_ORDER) over fbuf's slots: t 0..3, t-dt 4..7,
  // t+dt 8..11.
  const float* f = fbuf;
  const FieldPtrs fp{{f + 4 * ncell, f, f + 8 * ncell, f + 5 * ncell, f + 6 * ncell, f + 7 * ncell,
                      f + ncell, f + 2 * ncell, f + 3 * ncell, f + 9 * ncell, f + 10 * ncell,
                      f + 11 * ncell}};
  const OutPtrs op{{gbuf, gbuf + ncell, gbuf + 2 * ncell, gbuf + 3 * ncell}};
  // over every buffer row: a shard's halo rows 1 and nb - 2 give the g its
  // owned rows' adjoint gathers (rows 0 and nb - 1 are computed and unread)
  k_residuals<MODE_SCALED_PARTIALS><<<dim3(ntx, nty, nb), NT, 0, s>>>(
      fp, op, tile_parts, nx, ny, nb, periodic, k, scale_sigma, scale_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if constexpr (BF16) {
    cudaFuncSetAttribute(k_bwd_adjoint_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
    k_bwd_adjoint_bf16<<<nblk, NT, smem3, s>>>(ab, cd, w2t, fbuf, gbuf, dab_part, dcd_part, dw2_part, db2_part, nx,
                                               ny, zr, H, periodic, k);
  } else {
    cudaFuncSetAttribute(k_bwd_adjoint, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
    k_bwd_adjoint<<<nblk, NT, smem3, s>>>(ab, cd, w2t, fbuf, gbuf, dab_part, dcd_part, dw2_part, db2_part, nx, ny,
                                          zr, H, periodic, k);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)mlph::launch_sums<3>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2, nx, ny,
                                   nz_local, H, nblk, s);
}

}  // namespace

extern "C" int pat_mega_bwd(const float* ab, const float* cd, const float* w2t, const float* b2,
                            float* tile_parts, float* gbuf, float* fbuf, float* dab_part,
                            float* dcd_part, float* dw2_part, float* db2_part, float* dab, float* dcd,
                            float* dw2t, float* db2, int nx, int ny, int nz, int z0,
                            int nz_local, int H, int nblk, int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy,
                            float inv2hz, float scale_sigma, float scale_u, void* stream) {
  return launch<false>(ab, cd, w2t, b2, tile_parts, gbuf, fbuf, dab_part, dcd_part, dw2_part, db2_part, dab, dcd,
                       dw2t, db2, nx, ny, nz, z0, nz_local, H, nblk, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz,
                       scale_sigma, scale_u, stream);
}

// The bf16 tier: the same arguments.
extern "C" int pat_mega_bwd_bf16(const float* ab, const float* cd, const float* w2t, const float* b2,
                                 float* tile_parts, float* gbuf, float* fbuf, float* dab_part,
                                 float* dcd_part, float* dw2_part, float* db2_part, float* dab, float* dcd,
                                 float* dw2t, float* db2, int nx, int ny, int nz, int z0,
                                 int nz_local, int H, int nblk, int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy,
                                 float inv2hz, float scale_sigma, float scale_u, void* stream) {
  return launch<true>(ab, cd, w2t, b2, tile_parts, gbuf, fbuf, dab_part, dcd_part, dw2_part, db2_part, dab, dcd,
                      dw2t, db2, nx, ny, nz, z0, nz_local, H, nblk, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz,
                      scale_sigma, scale_u, stream);
}
