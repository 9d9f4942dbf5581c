// P1: the per-launch floor probe, sm_90a.
//
// Replaces the pallas_call of bound_min_call
// (scripts/small_grid_experiments.py:34): one [py, px] float32 plane copied
// in, +1.0, copied out. Its time is the card's per-launch floor: the least
// a launch of any kernel of the port costs, which the transport kernels'
// bounds (a few microseconds at 128x96x96) sit near.
//
// Bound: memory, 8 B a cell (4 read, 4 written) and 1 FP32 operation; at
// [96, 128] that is 98 KB, 0.03 us at 3.35 TB/s, so the launch is all that
// is measured. One thread a cell, 256 threads a block.

#include <cuda_runtime.h>

namespace {

__global__ void k_probe(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(in[i], 1.f);
}

}  // namespace

extern "C" int pat_probe(const float* in, float* out, int n, void* stream) {
  k_probe<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
