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
//   3. k_bwd_adjoint, ZC = 8 rows a chunk:
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
// The bf16 tier (pat_mega_bwd_bf16; k_bwd_fields<true>, k_bwd_adjoint<true>):
// the same passes with layer 2's three contractions on the tensor cores
// (mlp_mma.cuh), every operand rounded to bf16 and float32 sums, as the TPU's
// bf16 tier (pallas/mega_bwd.py:633-634, 705-750): pass 1 is K2's bf16
// forward (fields_chunk); pass 3's phase A writes dF and g/(2dt) in bf16,
// in the operand layouts of both contractions (store_gy), and phase B is
// bwd_block<3>: a warp per 16 hidden units, da1 = W2 . (dF, q) by
// m16n8k8, dW2 += a1_t . dF + a1_tp1 . q + a1_tm1 . (-q) by m16n8k16, the
// masks, dAB and dCD on the CUDA cores. Per (cell, hidden unit) the CUDA
// cores keep about 16.5 operations of the backward (the three slices' add,
// max, mask, dAB and dCD adds, dW2's converts) and 6 of the forward; with
// the residual and its adjoint 22.5 H + 316 a cell: 0.057 ms at H = 128
// on 128x96x96 at 67 TFLOP/s, against 128 H a cell of tensor-core FLOP as
// issued (0.020 ms at 989 TFLOP/s; chip_smoke.py's work table). Shared
// memory of pass 3: the bf16 cotangents (66 KB), the CD rows, the dW2T
// sums and each warp's dCD rows [ZC][3][16] (12 KB): 92 KB at H = 128; the
// host gates H <= 1360.
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
// [HP][ZF][4]; the adjoint pass dF and g/(2dt) in bf16 twice (gyp, gyt: the
// same 64 KB), the CD rows [ZC][HP][3], the dW2T sums [HP][4] and each
// warp's dCD rows [ZC][3][16]; HP padded to 16.
__host__ __device__ inline size_t fields_smem_bf16(int H) {
  return (size_t)(4 + (ZF + 1) * 4) * mma16::pad16(H) * sizeof(float);
}
__host__ __device__ inline size_t adjoint_smem_bf16(int H) {
  const int HP = mma16::pad16(H);
  return mma16::gy_bytes(ZC, 2) + ((size_t)ZC * HP * 3 + 4 * (size_t)HP) * sizeof(float) +
         (size_t)NW * ZC * 3 * 16 * sizeof(float);
}

// Pass 1: the fields of the three slices (see the file comment); BF16: on
// the tensor cores (mlp_mma.cuh fields_chunk, K2's bf16 routine).
template <bool BF16>
__global__ void __launch_bounds__(NT, 2)
    k_bwd_fields(const float* __restrict__ ab, const float* __restrict__ cd,
                 const float* __restrict__ w2t, const float* __restrict__ b2, mlph::Chans out, int nx,
                 int ny, pat::ZRows zr, int periodic, int H) {
  constexpr int P = BF16 ? 4 : 3, NROW = BF16 ? ZF + 1 : ZF;  // bf16: one padding row (fields_chunk)
  extern __shared__ float4 sh4[];
  const int HP = BF16 ? mma16::pad16(H) : mlph::pad4(H);
  float4* w2_s = sh4;                                  // [HP] (bf16: W2's B fragments [2 HP] uint2)
  float* cd_s = reinterpret_cast<float*>(sh4 + HP);    // [HP][NROW][P]
  // the buffer rows: local rows and their halo rows (pat::ZRows); row b
  // holds global row z0 - hz + b, wrapped or clamped (load_cd_rows maps it)
  const int nz = zr.nb(), zc0 = zr.z0 - zr.hz;
  const int ntx = (nx + TX - 1) / TX, nrows = ntx * ((ny + TY - 1) / TY) * nz;
  if constexpr (BF16) {
    mma16::load_w2_frags<false>(reinterpret_cast<uint2*>(sh4), w2t, H, HP);
  } else {
    mlph::load_w2(w2_s, w2t, H, HP);
  }
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZF, nz, ntx);
    __syncthreads();  // fields: the last chunk done with cd_s
    mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zc0 + c.z0, c.n, zr.nz, periodic, H, HP);
    __syncthreads();  // fields: the chunk's CD rows in
    if constexpr (BF16) {
      mma16::fields_chunk<3, ZF, P, false>(ab, cd_s, reinterpret_cast<const uint2*>(sh4), nullptr, b2r, out, c,
                                           nx, ny, H);
    } else {
      mlph::fields_chunk<3, ZF>(ab, cd_s, w2_s, b2r, out, c, nx, ny, H);
    }
    r += c.n;
  }
}

// Pass 3 (see the file comment); BF16: phase A writes the cotangents in
// bf16 (mlp_mma.cuh store_gy) and phase B runs on the tensor cores, a warp
// per 16 hidden units (mma16::bwd_block<3>).
template <bool BF16>
__global__ void __launch_bounds__(NT, 2)
    k_bwd_adjoint(const float* __restrict__ ab, const float* __restrict__ cd,
                  const float* __restrict__ w2t, const float* __restrict__ fbuf,
                  const float* __restrict__ gbuf, float* __restrict__ dab_part,
                  float* __restrict__ dcd_part, float* __restrict__ dw2_part,
                  float* __restrict__ db2_part, int nx, int ny, pat::ZRows zr, int H, int periodic,
                  pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  const int HP = BF16 ? mma16::pad16(H) : mlph::pad4(H);
  float4* gy_s = sh4;                                  // [ZC][NT][2]: dF, g / (2dt)
  // bf16: gyp [ZC][2][NT][2] uint32 and gyt [ZC][2][4][GT] bf16 (mlp_mma.cuh)
  uint32_t* gyp = reinterpret_cast<uint32_t*>(sh4);
  uint16_t* gyt = reinterpret_cast<uint16_t*>(gyp + ZC * 2 * NT * 2);
  float4* w2_s = sh4 + ZC * NT * 2;                    // [HP] (f32 only)
  float* cd_s = BF16 ? reinterpret_cast<float*>(reinterpret_cast<char*>(sh4) + mma16::gy_bytes(ZC, 2))
                     : reinterpret_cast<float*>(w2_s + HP);  // [ZC][HP][3]
  float* dw_s = cd_s + ZC * HP * 3;                    // [HP][4]
  float* dcd_w = dw_s + 4 * HP;                        // bf16: [NW][ZC][3][16]
  __shared__ float red[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5;
  // the walk covers the owned rows (local z); their CD rows start at z0
  const int nz = zr.n;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  const float* cd_own = cd + (size_t)zr.z0 * H * 3;
  if constexpr (!BF16) mlph::load_w2(w2_s, w2t, H, HP);
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
      if constexpr (BF16) {
        mma16::store_gy<2>(gyp, gyt, zl, 0, tid, df.x, df.y, df.z, df.w);
        mma16::store_gy<2>(gyp, gyt, zl, 1, tid, gq.x, gq.y, gq.z, gq.w);
      } else {
        gy_s[(zl * NT + tid) * 2] = df;
        gy_s[(zl * NT + tid) * 2 + 1] = gq;
      }
    }
    __syncthreads();  // adjoint: A done (gy_s and the CD rows in)

    // ---- B: the backward of the chunk on the core ---------------------------
    float* slot = dab_blk + (size_t)c.tile * H * NT;
    if constexpr (BF16) {
      for (int hb = warp; 16 * hb < H; hb += NW)
        mma16::bwd_block<3>(ab, gyp, gyt, cd_s, w2t, slot, dcd_part, dcd_w + warp * ZC * 3 * 16, dw_s, c, first,
                            16 * hb, H, HP, nx, ny, ntiles);
    } else {
      for (int hp = warp; 2 * hp < H; hp += NW)
        mlph::bwd_item<3>(ab, gy_s, cd_s, w2_s, slot, dcd_part, dw_s, c, first, 2 * hp, H, HP, nx, ny,
                          ntiles);
    }
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
  const size_t smem1 = BF16 ? fields_smem_bf16(H) : fields_smem_bytes(H);
  const size_t smem3 = BF16 ? adjoint_smem_bf16(H) : adjoint_smem_bytes(H);
  const int nb = zr.nb();
  const size_t ncell = (size_t)nb * ny * nx;
  if (H < 1 || nblk < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
      smem3 + 4 * 2 * NW > (size_t)mlph::SMEM_LIMIT || nz_local < 1 || z0 < 0 || z0 + nz_local > nz ||
      (zr.hz == 0 && z0 != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  cudaFuncSetAttribute(k_bwd_fields<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  // fbuf's channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11 ([sigma, u]).
  mlph::Chans out;
  const int slot[3] = {4, 0, 8};
  for (int k = 0; k < 3; ++k)
    for (int o = 0; o < 4; ++o) out.p[k * 4 + o] = fbuf + (slot[k] + o) * ncell;
  k_bwd_fields<BF16><<<nblk, NT, smem1, s>>>(ab, cd, w2t, b2, out, nx, ny, zr, periodic, H);
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

  cudaFuncSetAttribute(k_bwd_adjoint<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  k_bwd_adjoint<BF16><<<nblk, NT, smem3, s>>>(ab, cd, w2t, fbuf, gbuf, dab_part, dcd_part, dw2_part, db2_part,
                                        nx, ny, zr, H, periodic, k);
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
