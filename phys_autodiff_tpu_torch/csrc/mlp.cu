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
//
// The bf16 and bf16x3 tiers (k_mlp_fields_bf16, pat_mlp_fields_bf16): the
// same walk and chunks with layer 2 on the tensor cores (mlp_mma.cuh
// fields_chunk: a warp per tile row, two 16-cell A fragments, two (row,
// slice) values a C fragment, W2's B fragments from shared memory, AB
// streamed through the warp's ring by cp.async; bf16x3 three products a
// k-step). Per cell, slice and hidden unit the CUDA cores keep the add and
// half a convert that also clamps, 1.5 instructions (bf16x3: the add, the
// max, half a convert, float(hi) read off the packed pair, the subtraction
// and half a convert, 5), against the f32 kernel's 10 operations; the
// tensor cores run 16 x 8 x 16 products a
// k-step with [W2 | 0] or [0 | W2] (Out = 4): 2 x 8 x 16 = 256 FLOP per
// (cell, slice) per 16 hidden units issued, 4 H x 3 at bf16x3. Bound at
// S = 3, H = 128 on 128x96x96 (chip_smoke.py's work table): the bytes (the
// 62.9 MB of fields and the tables) = 0.0188 ms at 3.35 TB/s, against 2 H a
// (cell, slice) of CUDA-core operations (0.0135 ms at 67 TFLOP/s) and
// 0.0073 ms of tensor-core FLOP at 989 TFLOP/s. Shared memory: W2's B
// fragments (16 B a hidden unit, twice for bf16x3), the CD rows
// [HP][ZF + 1][P] (P = 4 at S = 3, 1 at S = 1; one padding row, see
// fields_chunk), HP = H padded to 16: 96 HP bytes at S = 3 (112 for
// bf16x3), and the warps' AB rings, 10 KB a stage, as deep as
// mma16::ring_stages allows (2 stages at H = 128, two blocks an SM; none
// at the top H); the host gates H <= 2416 (2064).

#include "mlp_mma.cuh"

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

// The bf16 tier's dynamic shared memory (bytes) beside the warps' AB rings
// (mlp_mma.cuh ring_stages, ring_bytes): W2's B fragments (twice for
// bf16x3) and the CD rows [HP16][ZF + 1][P] (mlp_mma.cuh fields_chunk).
template <int S>
constexpr int P_OF = S == 3 ? 4 : 1;
template <int S>
size_t fields_smem_bf16(int H, bool x3) {
  const size_t hp = mma16::pad16(H);
  return hp * (16 * (x3 ? 2 : 1) + 4 * (ZF_OF<S> + 1) * P_OF<S>);
}

template <int S, bool X3, bool RING>
__global__ void __launch_bounds__(NT, 2)
    k_mlp_fields_bf16(const float* __restrict__ ab, const float* __restrict__ cd,
                      const float* __restrict__ w2t, const float* __restrict__ b2, mlph::Chans out, int nx,
                      int ny, int nz, int H) {
  constexpr int ZF = ZF_OF<S>, P = P_OF<S>;
  extern __shared__ float4 sh4[];
  uint2* shu = reinterpret_cast<uint2*>(sh4);
  const int HP = mma16::pad16(H);
  uint2* w2f = shu;                                     // [2 HP]
  uint2* w2f_lo = shu + 2 * HP;                         // [2 HP] (bf16x3)
  float* cd_s = reinterpret_cast<float*>(shu + (X3 ? 4 : 2) * HP);  // [HP][ZF + 1][P]
  float* ring_s = cd_s + (size_t)HP * (ZF + 1) * P;     // [NW][FW_NS][FW_STAGE]: the warps' AB rings (RING)
  const int ntx = (nx + TX - 1) / TX, nrows = ntx * ((ny + TY - 1) / TY) * nz;
  mma16::load_w2_frags<false>(w2f, w2t, H, HP);
  if constexpr (X3) mma16::load_w2_frags<true>(w2f_lo, w2t, H, HP);
  mma16::set_chans(out);
  int r0, r1;
  mlph::block_rows(nrows, r0, r1);
  for (int r = r0; r < r1;) {
    const mlph::Chunk c = mlph::chunk_at(r, r1, ZF, nz, ntx);
    __syncthreads();  // mlp bf16: the last chunk done with cd_s
    mma16::AbRing ring = mma16::ring_start<RING>(ring_s, ab, c, nx, ny, H);
    mlph::load_cd_rows<S, ZF + 1, P>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);
    __syncthreads();  // mlp bf16: the chunk's CD rows in
    mma16::fields_chunk<S, ZF, P, X3, RING>(ring, cd_s, w2f, w2f_lo, b2, c, nx, ny);
    r += c.n;
  }
}

// The channel map of S slices: sigma channel s at sigma_out + s N, u channel
// c of slice s at u_out + (3 s + c) N.
template <int S>
mlph::Chans channels(float* sigma_out, float* u_out, size_t n) {
  mlph::Chans out;
  for (int s = 0; s < S; ++s) {
    out.p[s * 4] = sigma_out + s * n;
    for (int c = 0; c < 3; ++c) out.p[s * 4 + 1 + c] = u_out + (s * 3 + c) * n;
  }
  return out;
}

template <int S, bool X3>
cudaError_t launch_bf16(const float* ab, const float* cd, const float* w2t, const float* b2, float* sigma_out,
                        float* u_out, int nx, int ny, int nz, int H, int nblk, cudaStream_t st) {
  const size_t fixed = fields_smem_bf16<S>(H, X3);
  if (fixed + mma16::FW_STATIC > (size_t)mlph::SMEM_LIMIT) return cudaErrorInvalidValue;
  const int ns = mma16::ring_stages(fixed, nx, ab);
  const size_t smem = fixed + mma16::ring_bytes(ns);
  const mlph::Chans out = channels<S>(sigma_out, u_out, (size_t)nz * ny * nx);
  auto kernel = ns ? k_mlp_fields_bf16<S, X3, true> : k_mlp_fields_bf16<S, X3, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<nblk, NT, smem, st>>>(ab, cd, w2t, b2, out, nx, ny, nz, H);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const float* ab, const float* cd, const float* w2t, const float* b2, float* sigma_out,
                   float* u_out, int nx, int ny, int nz, int H, int nblk, cudaStream_t st) {
  const size_t smem = fields_smem_bytes<S>(H);
  if (smem > (size_t)mlph::SMEM_LIMIT) return cudaErrorInvalidValue;
  const mlph::Chans out = channels<S>(sigma_out, u_out, (size_t)nz * ny * nx);
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

// The bf16 tier (x3 = 0) or bf16x3 (x3 = 1) of pat_mlp_fields, the same
// arguments.
extern "C" int pat_mlp_fields_bf16(const float* ab, const float* cd, const float* w2t, const float* b2,
                                   float* sigma_out, float* u_out, int nx, int ny, int nz, int H, int S, int nblk,
                                   int x3, void* stream) {
  const int nrows = ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * nz;
  if (H < 1 || nblk != (nrows < mlph::NBLK ? nrows : mlph::NBLK)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 3 && !x3) return (int)launch_bf16<3, false>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  if (S == 3 && x3) return (int)launch_bf16<3, true>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  if (S == 1 && !x3) return (int)launch_bf16<1, false>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  if (S == 1 && x3) return (int)launch_bf16<1, true>(ab, cd, w2t, b2, sigma_out, u_out, nx, ny, nz, H, nblk, st);
  return (int)cudaErrorInvalidValue;
}

namespace {

// One m16n8k16 fragment through the forward's packing and mma16816: A
// [16][16] and B [16][8] row-major float32 in, D = bf16(A) bf16(B) [16][8]
// out, and packed[r][j] = the register pack2(A[r][2j], A[r][2j + 1]) (one
// warp), for a check against torch.bfloat16 on the card.
__global__ void k_mma_check(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ d,
                            uint32_t* __restrict__ packed) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  auto A = [&](int r, int col) { return a[r * 16 + col]; };
  auto B = [&](int k, int n) { return b[k * 8 + n]; };
  const uint32_t a0 = mma16::pack2(A(g, 2 * t), A(g, 2 * t + 1));
  const uint32_t a1 = mma16::pack2(A(g + 8, 2 * t), A(g + 8, 2 * t + 1));
  const uint32_t a2 = mma16::pack2(A(g, 2 * t + 8), A(g, 2 * t + 9));
  const uint32_t a3 = mma16::pack2(A(g + 8, 2 * t + 8), A(g + 8, 2 * t + 9));
  const uint32_t b0 = mma16::pack2(B(2 * t, g), B(2 * t + 1, g));
  const uint32_t b1 = mma16::pack2(B(2 * t + 8, g), B(2 * t + 9, g));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma16::mma16816(acc, a0, a1, a2, a3, b0, b1);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
  packed[g * 8 + t] = a0;
  packed[(g + 8) * 8 + t] = a1;
  packed[g * 8 + t + 4] = a2;
  packed[(g + 8) * 8 + t + 4] = a3;
}

}  // namespace

extern "C" int pat_mma_check(const float* a, const float* b, float* d, uint32_t* packed, void* stream) {
  k_mma_check<<<1, 32, 0, (cudaStream_t)stream>>>(a, b, d, packed);
  return (int)cudaGetLastError();
}
