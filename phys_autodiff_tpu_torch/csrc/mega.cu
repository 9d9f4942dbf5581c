// K3: the MLP -> residual -> loss-partials mega-kernel, sm_90a.
//
// Replaces _build_mega_call of phys_autodiff_tpu/pallas/mega.py (:316). The
// kernel body, and the notes on what bounds it and how it is laid out, are
// in mega.cuh.

#include "mega.cuh"

extern "C" int pat_mega_partials(const float* ab, const float* cd, const float* w2t,
                                 const float* b2, float* tile_parts, int nx, int ny, int nz, int H,
                                 int zrows, int periodic, int upwind, float inv2dt, float inv2hx,
                                 float inv2hy, float inv2hz, void* stream) {
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + zrows - 1) / zrows);
  const size_t smem = mega_smem_bytes(H, zrows);
  cudaFuncSetAttribute(k_mega, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k_mega<<<grid, NT, smem, (cudaStream_t)stream>>>(ab, cd, w2t, b2, tile_parts, nx, ny, nz, H, zrows,
                                                   periodic, k);
  return (int)cudaGetLastError();
}
