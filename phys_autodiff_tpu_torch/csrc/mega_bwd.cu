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
//   1. k_bwd_fields: thread per cell, ZF = 4 rows a chunk, all four
//      evaluated (AB read once for them; W2 and the CD rows as float4
//      broadcasts; a short chunk's missing rows meet zero CD rows and are
//      not stored; ZF = 6 ran slower): the three slices'
//      y_s = W2T relu(AB + CD[z, :, s]) + b2 to fbuf [12, nz, ny, nx] (t
//      slice first, so fbuf[0:4] is the [4, nz, ny, nx] the adjoint reads;
//      t-dt 4..7, t+dt 8..11). No x/y halo and no extra z row is evaluated:
//      every field value once. 10 KB of shared memory at H = 128.
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
// run FFMA on the CUDA cores (W2 has 4 columns, too narrow for the tensor
// cores).
//
// The clamp z edge at nz = 1: the forward z difference is identically 0
// there, so its adjoint is 0. The gather form of adjoint.cuh gives exactly
// that; the TPU kernel's edge legs do not (ROADMAP.md Queue C, R4).

#include "adjoint.cuh"
#include "mlp_head.cuh"
#include "residuals.cuh"

namespace {

using mlph::NW;
constexpr int ZF = 4;  // rows of a chunk of the fields pass
constexpr int ZC = 8;  // rows of a chunk of the adjoint pass (kernels/mega_bwd.py ZROWS)

// Dynamic shared memory (bytes) of the fields pass (W2 and the CD rows,
// float4 each) and of the adjoint pass (dF and g/(2dt), the CD rows, W2,
// the dW2T sums).
__host__ __device__ inline size_t fields_smem_bytes(int H) {
  return (size_t)(1 + ZF) * mlph::pad4(H) * sizeof(float4);
}
__host__ __device__ inline size_t adjoint_smem_bytes(int H) {
  const int HP = mlph::pad4(H);
  return (size_t)ZC * NT * 2 * sizeof(float4) + ((size_t)ZC * HP * 3 + 8 * (size_t)HP) * sizeof(float);
}

// Pass 1: the fields of the three slices (see the file comment).
__global__ void __launch_bounds__(NT, 2)
    k_bwd_fields(const float* __restrict__ ab, const float* __restrict__ cd,
                 const float* __restrict__ w2t, const float* __restrict__ b2,
                 float* __restrict__ fbuf, int nx, int ny, int nz, int H) {
  extern __shared__ float4 sh4[];
  const int HP = mlph::pad4(H);
  float4* w2_s = sh4;       // [HP]
  float4* cd_s = sh4 + HP;  // [ZF][HP]: (t-dt, t, t+dt, 0)
  const int tid = threadIdx.x;
  const int ntx = (nx + TX - 1) / TX, nrows = ntx * ((ny + TY - 1) / TY) * nz;
  const size_t plane = (size_t)nx * ny, ncell = (size_t)nz * plane;
  mlph::load_w2(w2_s, w2t, H, HP);
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZF, nz, ntx);
    __syncthreads();  // fields: the last chunk done with cd_s
    for (int i = tid; i < ZF * HP; i += NT) {
      const int zl = i / HP, h = i % HP;
      const float* src = cd + ((size_t)(c.z0 + zl) * H + h) * 3;
      cd_s[i] = zl < c.n && h < H ? make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), 0.f)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // fields: the chunk's CD rows in
    const int gx = c.x0 + tid % TX, gy = c.y0 + tid / TX;
    if (gx < nx && gy < ny) {
      const size_t cell = (size_t)gy * nx + gx;
      float acc[ZF][3][4];
#pragma unroll
      for (int zl = 0; zl < ZF; ++zl)
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int o = 0; o < 4; ++o) acc[zl][k][o] = 0.f;
      // All ZF rows, straight-line: the CD rows past the chunk are zero, and
      // what they give is not stored.
#pragma unroll 4
      for (int h = 0; h < H; ++h) {
        const float a = __ldg(ab + h * plane + cell);
        const float4 w = w2_s[h];
#pragma unroll
        for (int zl = 0; zl < ZF; ++zl) {
          const float4 t = cd_s[zl * HP + h];
          const float tv[3] = {t.x, t.y, t.z};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float act = fmaxf(a + tv[k], 0.f);
            acc[zl][k][0] = fmaf(act, w.x, acc[zl][k][0]);
            acc[zl][k][1] = fmaf(act, w.y, acc[zl][k][1]);
            acc[zl][k][2] = fmaf(act, w.z, acc[zl][k][2]);
            acc[zl][k][3] = fmaf(act, w.w, acc[zl][k][3]);
          }
        }
      }
      // fbuf channel blocks: t slice 0..3, t-dt 4..7, t+dt 8..11 ([sigma, u]).
      const int slot[3] = {4, 0, 8};
#pragma unroll
      for (int zl = 0; zl < ZF; ++zl) {
        if (zl < c.n) {
          const size_t at = (size_t)(c.z0 + zl) * plane + cell;
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int o = 0; o < 4; ++o) fbuf[(slot[k] + o) * ncell + at] = acc[zl][k][o] + b2r[o];
        }
      }
    }
    r += c.n;
  }
}

// Pass 3 (see the file comment).
__global__ void __launch_bounds__(NT, 2)
    k_bwd_adjoint(const float* __restrict__ ab, const float* __restrict__ cd,
                  const float* __restrict__ w2t, const float* __restrict__ fbuf,
                  const float* __restrict__ gbuf, float* __restrict__ dab_part,
                  float* __restrict__ dcd_part, float* __restrict__ dw2_part,
                  float* __restrict__ db2_part, int nx, int ny, int nz, int H, int periodic,
                  pat::StencilConsts k) {
  extern __shared__ float4 sh4[];
  const int HP = mlph::pad4(H);
  float4* gy_s = sh4;                                  // [ZC][NT][2]: dF, g / (2dt)
  float4* w2_s = sh4 + ZC * NT * 2;                    // [HP]
  float* cd_s = reinterpret_cast<float*>(w2_s + HP);   // [ZC][HP][3]
  float* dw_s = cd_s + ZC * HP * 3;                    // [HP][4]
  __shared__ float red[2 * NW];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ntx = (nx + TX - 1) / TX, ntiles = ntx * ((ny + TY - 1) / TY), nrows = ntiles * nz;
  mlph::load_w2(w2_s, w2t, H, HP);
  for (int i = tid; i < 4 * HP; i += NT) dw_s[i] = 0.f;
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  float* dab_blk = dab_part + (size_t)blockIdx.x * H * NT;  // slot blk + tile

  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZC, nz, ntx);
    const bool first = r == r0 || c.z0 == 0;
    __syncthreads();  // adjoint: the last chunk's B done with gy_s and cd_s
    mlph::load_cd<3>(cd_s, cd, c.z0, c.n, ZC, H, HP);

    // ---- A: field cotangents of every cell of the chunk ------------------
    const int gx = c.x0 + tid % TX, gy = c.y0 + tid / TX;
    for (int zl = 0; zl < c.n; ++zl) {
      float4 df = make_float4(0.f, 0.f, 0.f, 0.f), gq = df;
      if (gx < nx && gy < ny) {
        float d[4], gc[4];
        pat::t_slice_adjoint(fbuf, gbuf, gx, gy, c.z0 + zl, nx, ny, nz, periodic, k, d, gc);
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
      mlph::bwd_item<3>(ab, gy_s, cd_s, w2_s, slot, dcd_part, dw_s, c, first, 2 * hp, H, HP, nx, ny,
                        ntiles);
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

// AB [H, ny, nx], CD [nz, H, 3], W2T [4, H], b2 [4]; scratch: tile
// partials [2, nz, ntiles], g [4, N], the fields [12, N], dAB partials
// [nblk + ntiles - 1, H, 256], dCD partials [nz, ntiles, H, 3], dW2T
// partials [nblk, 4, H], db2 partials [nblk, 4]; outputs dAB [H, ny, nx],
// dCD [nz, H, 3], dW2T [4, H], db2 [4]. nblk = min(tile rows, NBLK) (the
// host computes it); the adjoint pass's shared memory within a block's (the
// host gates).
extern "C" int pat_mega_bwd(const float* ab, const float* cd, const float* w2t, const float* b2,
                            float* tile_parts, float* gbuf, float* fbuf, float* dab_part,
                            float* dcd_part, float* dw2_part, float* db2_part, float* dab, float* dcd,
                            float* dw2t, float* db2, int nx, int ny, int nz, int H, int nblk,
                            int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy,
                            float inv2hz, float scale_sigma, float scale_u, void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  cudaStream_t s = (cudaStream_t)stream;
  const int ntx = (nx + TX - 1) / TX, nty = (ny + TY - 1) / TY, nrows = ntx * nty * nz;
  const size_t smem1 = fields_smem_bytes(H), smem3 = adjoint_smem_bytes(H);
  if (H < 1 || nblk < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK) ||
      smem3 + 4 * 2 * NW > (size_t)mlph::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const size_t ncell = (size_t)nz * ny * nx;
  cudaError_t err;

  cudaFuncSetAttribute(k_bwd_fields, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  k_bwd_fields<<<nblk, NT, smem1, s>>>(ab, cd, w2t, b2, fbuf, nx, ny, nz, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // K1's channel order (PACKED_ORDER) over fbuf's slots: t 0..3, t-dt 4..7,
  // t+dt 8..11.
  const float* f = fbuf;
  const FieldPtrs fp{{f + 4 * ncell, f, f + 8 * ncell, f + 5 * ncell, f + 6 * ncell, f + 7 * ncell,
                      f + ncell, f + 2 * ncell, f + 3 * ncell, f + 9 * ncell, f + 10 * ncell,
                      f + 11 * ncell}};
  const OutPtrs op{{gbuf, gbuf + ncell, gbuf + 2 * ncell, gbuf + 3 * ncell}};
  k_residuals<MODE_SCALED_PARTIALS><<<dim3(ntx, nty, nz), NT, 0, s>>>(
      fp, op, tile_parts, nx, ny, nz, periodic, k, scale_sigma, scale_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  cudaFuncSetAttribute(k_bwd_adjoint, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  k_bwd_adjoint<<<nblk, NT, smem3, s>>>(ab, cd, w2t, fbuf, gbuf, dab_part, dcd_part, dw2_part, db2_part,
                                        nx, ny, nz, H, periodic, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)mlph::launch_sums<3>(dab_part, dcd_part, dw2_part, db2_part, dab, dcd, dw2t, db2, nx, ny,
                                   nz, H, nblk, s);
}
