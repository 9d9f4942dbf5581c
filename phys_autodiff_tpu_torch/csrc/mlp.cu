// K2: fused MLP field generation, sm_90a.
//
// Replaces _build_call of phys_autodiff_tpu/pallas/mlp.py (:199). Layer 1 of
// the coordinate MLP is folded on the host side into the rank-1 tables
//   AB[h, y, x] = W1[x,h] cx[x] + W1[y,h] cy[y]                 [H, ny, nx]
//   CD[z, h, s] = W1[z,h] cz[z] + W1[t,h] (t_s + t_off) + b1[h]  [nz, H, S]
// (fold_ab_plane / fold_cd, plain tensor ops as in the JAX package), and the
// kernel computes, for S time slices,
//   y[s, o] = sum_h W2T[o, h] relu(AB[h, y, x] + CD[z, h, s]) + b2[o]
// writing sigma (o = 0) at sigma_out[s] and u (o = 1..3) at
// u_out[s * 3 + o - 1], channel planes of nz*ny*nx cells. The packed layout
// ([12, nz, ny, nx], PACKED_ORDER) is sigma_out = packed, u_out = packed + 3N.
//
// Bound on this card: FP32 instruction throughput. Per cell and slice the
// kernel does H adds, H max and 4H FMAs (Out = 4 makes tensor cores
// pointless), against 16 B of output and H*4 B of AB reads shared by all S
// slices. Design: one thread
// per (y, x) cell of one z plane, x fastest so the AB reads and the output
// writes coalesce; the CD row of the plane and W2T sit in shared memory and
// are read as warp broadcasts; each AB value is loaded once and feeds all S
// slices, with 4*S accumulators in registers. FMAs are allowed here: the
// tolerance class of field generation is MLP_INFER_REL (1e-6), not the
// stencil's 1e-7.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

template <int S>
__global__ void __launch_bounds__(NT)
    k_mlp_fields(const float* __restrict__ ab, const float* __restrict__ cd,
                 const float* __restrict__ w2t, const float* __restrict__ b2,
                 float* __restrict__ sigma_out, float* __restrict__ u_out, int plane, int nz,
                 int H) {
  extern __shared__ float sh[];
  float* cd_s = sh;          // [H * S]: CD[z, h, s]
  float* w2_s = sh + H * S;  // [4 * H]: W2T[o, h]
  const int z = blockIdx.y;
  for (int i = threadIdx.x; i < H * S; i += NT) cd_s[i] = cd[(size_t)z * H * S + i];
  for (int i = threadIdx.x; i < 4 * H; i += NT) w2_s[i] = w2t[i];
  __syncthreads();
  const int cell = blockIdx.x * NT + threadIdx.x;
  if (cell >= plane) return;

  float acc[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[s][o] = 0.f;

  const float* abp = ab + cell;
#pragma unroll 4
  for (int h = 0; h < H; ++h) {
    const float a = __ldg(abp + (size_t)h * plane);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float act = fmaxf(a + cd_s[h * S + s], 0.f);
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[s][o] = fmaf(act, w2_s[o * H + h], acc[s][o]);
    }
  }

  const size_t n = (size_t)nz * plane, at = (size_t)z * plane + cell;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    sigma_out[s * n + at] = acc[s][0] + __ldg(b2);
#pragma unroll
    for (int c = 0; c < 3; ++c) u_out[(s * 3 + c) * n + at] = acc[s][c + 1] + __ldg(b2 + c + 1);
  }
}

}  // namespace

extern "C" int pat_mlp_fields(const float* ab, const float* cd, const float* w2t, const float* b2,
                              float* sigma_out, float* u_out, int plane, int nz, int H, int S,
                              void* stream) {
  const dim3 grid((plane + NT - 1) / NT, nz);
  const size_t smem = (size_t)H * (S + 4) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 3) {
    cudaFuncSetAttribute(k_mlp_fields<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k_mlp_fields<3><<<grid, NT, smem, st>>>(ab, cd, w2t, b2, sigma_out, u_out, plane, nz, H);
  } else if (S == 1) {
    cudaFuncSetAttribute(k_mlp_fields<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k_mlp_fields<1><<<grid, NT, smem, st>>>(ab, cd, w2t, b2, sigma_out, u_out, plane, nz, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
