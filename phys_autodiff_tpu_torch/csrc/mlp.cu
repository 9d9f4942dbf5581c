// K2: fused MLP field generation, sm_90a.
//
// Replaces _build_call of phys_autodiff_tpu/pallas/mlp.py (:199). Layer 1 of
// the coordinate MLP is folded on the host side into the rank-1 tables
//   AB[h, y, x] = W1[x,h] cx[x] + W1[y,h] cy[y]                 [H, ny, nx]
//   CD[z, h, s] = W1[z,h] cz[z] + W1[t,h] (t_s + t_off) + b1[h]  [nz, H, S]
// (fold_ab_plane / fold_cd, plain tensor ops as in the JAX package), and the
// kernel computes, for S = 3 time slices (t-dt, t, t+dt) or S = 1 (t),
//   y[s, o] = sum_h W2T[o, h] relu(AB[h, y, x] + CD[z, h, s]) + b2[o]
// writing sigma (o = 0) at sigma_out[s] and u (o = 1..3) at
// u_out[s * 3 + o - 1], channel planes of nz*ny*nx cells. The packed layout
// ([12, nz, ny, nx], PACKED_ORDER) is sigma_out = packed, u_out = packed + 3N.
//
// Bound on this card: FP32 operations. Per cell and slice the function
// needs H adds, H max and 4H FMAs (an FMA counted as two: 10 H operations;
// Out = 4 makes tensor cores pointless), against 16 B of output and H*4 B of
// AB reads shared by all S slices and all z: 0.068 ms at S = 3, H = 128 on
// 128x96x96 (chip_smoke.py's work table).
//
// Design: the forward of the tiled MLP core (mlp_head.cuh fwd_chunk), the
// routine K3 and K4's fields pass run too, so a field value has the same
// bits in all three. A persistent grid of min(tile rows, 264) blocks walks
// contiguous ranges of 32 x 8 tile rows (tile-major, z fastest) in chunks
// of ZF rows of one tile, thread per cell: AB is read once a chunk for all
// its rows and slices (once per 4 rows at S = 3, 8 at S = 1), W2 and the chunk's CD rows come as
// float4 broadcasts from shared memory, the loop over hidden units holds no
// branch, and the stores of a warp fill whole 128-byte lines. A thread
// keeps ZF S x 4 accumulators (48 at S = 3, 32 at S = 1; ZF a power of two
// for the groups of a short chunk), within the 128 registers of two blocks
// an SM. The S = 1 t slice is the
// S = 3 kernel's t slice to the bit (the same chain). Shared memory: W2
// [HP] float4 and the CD rows [HP][ZF][S], 64 HP bytes at S = 3 and 48 HP
// at S = 1 (8 KB at H = 128); the host gates H <= 3632. FMAs are allowed
// here: the tolerance class of field generation is MLP_INFER_REL (1e-6),
// not the stencil's 1e-7.

#include "mlp_head.cuh"

namespace {

using mlph::NT;
using mlph::TX;
using mlph::TY;

// Rows of a chunk (kernels/mlp.py ZROWS).
template <int S>
constexpr int ZF_OF = S == 3 ? 4 : 8;

// Dynamic shared memory (bytes): W2 [HP] float4 and the CD rows [HP][ZF][S].
template <int S>
size_t fields_smem_bytes(int H) {
  return (size_t)(4 + ZF_OF<S> * S) * mlph::pad4(H) * sizeof(float);
}

template <int S>
__global__ void __launch_bounds__(NT, 2)
    k_mlp_fields(const float* __restrict__ ab, const float* __restrict__ cd,
                 const float* __restrict__ w2t, const float* __restrict__ b2, mlph::Chans out, int nx,
                 int ny, int nz, int H) {
  constexpr int ZF = ZF_OF<S>;
  extern __shared__ float4 sh4[];
  const int HP = mlph::pad4(H);
  float4* w2_s = sh4;                                // [HP]
  float* cd_s = reinterpret_cast<float*>(sh4 + HP);  // [HP][ZF][S]
  const int ntx = (nx + TX - 1) / TX, nrows = ntx * ((ny + TY - 1) / TY) * nz;
  mlph::load_w2(w2_s, w2t, H, HP);
  const float b2r[4] = {__ldg(b2), __ldg(b2 + 1), __ldg(b2 + 2), __ldg(b2 + 3)};
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZF, nz, ntx);
    __syncthreads();  // mlp: the last chunk done with cd_s
    mlph::load_cd_rows<S, ZF, S>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);
    __syncthreads();  // mlp: the chunk's CD rows in
    mlph::fields_chunk<S, ZF>(ab, cd_s, w2_s, b2r, out, c, nx, ny, H);
    r += c.n;
  }
}

template <int S>
cudaError_t launch(const float* ab, const float* cd, const float* w2t, const float* b2, float* sigma_out,
                   float* u_out, int nx, int ny, int nz, int H, int nblk, cudaStream_t st) {
  const size_t n = (size_t)nz * ny * nx, smem = fields_smem_bytes<S>(H);
  if (smem > (size_t)mlph::SMEM_LIMIT) return cudaErrorInvalidValue;
  mlph::Chans out;
  for (int s = 0; s < S; ++s) {
    out.p[s * 4] = sigma_out + s * n;
    for (int c = 0; c < 3; ++c) out.p[s * 4 + 1 + c] = u_out + (s * 3 + c) * n;
  }
  cudaFuncSetAttribute(k_mlp_fields<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_mlp_fields<S><<<nblk, NT, smem, st>>>(ab, cd, w2t, b2, out, nx, ny, nz, H);
  return cudaGetLastError();
}

}  // namespace

// AB [H, ny, nx], CD [nz, H, S], W2T [4, H], b2 [4]; outputs as above.
// nblk = min(tile rows, NBLK) (the host computes it).
extern "C" int pat_mlp_fields(const float* ab, const float* cd, const float* w2t, const float* b2,
                              float* sigma_out, float* u_out, int nx, int ny, int nz, int H, int S,
                              int nblk, void* stream) {
  const int nrows = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * nz;
  if (H < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 3) return (int)launch<3>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  if (S == 1) return (int)launch<1>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  return (int)cudaErrorInvalidValue;
}
