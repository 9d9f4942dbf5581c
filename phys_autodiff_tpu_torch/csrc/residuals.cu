// K1: the fused transport-residual kernel, sm_90a.
//
// Replaces the three pallas_call constructors of
// phys_autodiff_tpu/pallas/residuals.py
// (_build_fused_call :392, _build_plane_call :508, _build_packed_call :778).
// Those are one computation on three TPU layouts; here it is ONE kernel for
// any nx, ny, nz >= 1 that reads the 12 field channels through 12 base
// pointers (so separate FieldSnapshots and the packed [12, nz, ny, nx]
// array need no pack copy) and has three epilogues:
//   MODE_RESIDUALS  R = [R_sigma, R_ux, R_uy, R_uz] through 4 channel pointers
//   MODE_SCALED     g = (2w/N) R (the reference-shaped fused backward)
//   MODE_PARTIALS   per-(z plane, tile) sums of R_sigma^2 and |R_u|^2; the
//                   finalize pass adds them in a fixed order into [2, nz] and
//                   the fixed-order loss (no atomics: the loss is
//                   deterministic run to run)
//
// Bound on this card: memory. The compulsory traffic is 64 B/cell (12
// channel reads + 4 residual writes; 48 B/cell in the partials epilogue)
// against ~60 flops/cell. Design: one thread per cell, x fastest across a
// warp so every channel read and write is a coalesced 128-byte line; the
// 6 neighbour re-reads of the 4 t-slice channels hit L1/L2 (a block's tile
// and its z neighbours were just read by its neighbours), so DRAM sees
// close to the compulsory bytes.
//
// The bf16-I/O entry points (pat_residuals_bf16, pat_residuals_mixed_out)
// replace the dtype / out_dtype variants of _build_packed_call
// (residuals_fused_packed_bf16 :1037, residuals_fused_packed_mixed_out
// :1076): the same body instantiated for bf16 fields and / or bf16
// residuals, float32 arithmetic between (k_residuals<MODE_RESIDUALS, Tin,
// Tout>). They exist to move fewer bytes: 32 B a cell with bf16 in and
// out, 56 B with float32 in and bf16 out, against 64 B. The neighbour
// re-reads are bf16 too, so the cache holds twice the cells.

#include "residuals.cuh"

namespace {

// Fixed-order finalize: tile_parts [2, nz, ntiles] -> parts [2, nz] (tiles
// added in tile order), then loss[k] = (w_k * sum_z parts[k, z]) * inv_n
// with z added sequentially from 0 — the order of ops.loss.sum_partials.
__global__ void k_partials_finalize(const float* __restrict__ tile_parts, int ntiles, int nz,
                                    float* __restrict__ parts, float* __restrict__ loss,
                                    float w_sigma, float w_u, float inv_n) {
  for (int i = threadIdx.x; i < 2 * nz; i += blockDim.x) {
    const float* src = tile_parts + (size_t)i * ntiles;
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) acc = pat::add(acc, src[t]);
    parts[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const float* src = parts + (size_t)threadIdx.x * nz;
    float acc = 0.f;
    for (int zi = 0; zi < nz; ++zi) acc = pat::add(acc, src[zi]);
    const float w = threadIdx.x == 0 ? w_sigma : w_u;
    loss[threadIdx.x] = pat::mul(pat::mul(w, acc), inv_n);
  }
}

// K1 with bf16 residuals out: f* are bf16 (Tin = __nv_bfloat16) or float
// planes, o* bf16 planes.
template <class Tin>
int residuals_low_out(const void* const* f, void* const* o, int nx, int ny, int nz, int periodic, int upwind,
                      float inv2dt, float inv2hx, float inv2hy, float inv2hz, void* stream) {
  FieldPtrsT<Tin> fp;
  OutPtrsT<__nv_bfloat16> op;
  for (int i = 0; i < 12; ++i) fp.p[i] = static_cast<const Tin*>(f[i]);
  for (int i = 0; i < 4; ++i) op.p[i] = static_cast<__nv_bfloat16*>(o[i]);
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, nz);
  k_residuals<MODE_RESIDUALS, Tin, __nv_bfloat16><<<grid, NT, 0, (cudaStream_t)stream>>>(
      fp, op, nullptr, nx, ny, nz, periodic, k, 0.f, 0.f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pat_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int pat_residuals(const float* f0, const float* f1, const float* f2, const float* f3,
                  const float* f4, const float* f5, const float* f6, const float* f7,
                  const float* f8, const float* f9, const float* f10, const float* f11, float* o0,
                  float* o1, float* o2, float* o3, float* tile_parts, int nx, int ny, int nz,
                  int periodic, int upwind, int mode, float inv2dt, float inv2hx, float inv2hy,
                  float inv2hz, float scale_sigma, float scale_u, void* stream) {
  const FieldPtrs f{{f0, f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11}};
  const OutPtrs o{{o0, o1, o2, o3}};
  const pat::StencilConsts k{inv2dt, inv2hx, inv2hy, inv2hz, upwind};
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, nz);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_RESIDUALS:
      k_residuals<MODE_RESIDUALS><<<grid, NT, 0, s>>>(f, o, tile_parts, nx, ny, nz, periodic, k,
                                                      scale_sigma, scale_u);
      break;
    case MODE_SCALED:
      k_residuals<MODE_SCALED><<<grid, NT, 0, s>>>(f, o, tile_parts, nx, ny, nz, periodic, k,
                                                   scale_sigma, scale_u);
      break;
    case MODE_PARTIALS:
      k_residuals<MODE_PARTIALS><<<grid, NT, 0, s>>>(f, o, tile_parts, nx, ny, nz, periodic, k,
                                                     scale_sigma, scale_u);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int pat_residuals_bf16(const void* f0, const void* f1, const void* f2, const void* f3, const void* f4,
                       const void* f5, const void* f6, const void* f7, const void* f8, const void* f9,
                       const void* f10, const void* f11, void* o0, void* o1, void* o2, void* o3, int nx,
                       int ny, int nz, int periodic, int upwind, float inv2dt, float inv2hx, float inv2hy,
                       float inv2hz, void* stream) {
  const void* f[12] = {f0, f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11};
  void* o[4] = {o0, o1, o2, o3};
  return residuals_low_out<__nv_bfloat16>(f, o, nx, ny, nz, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz,
                                          stream);
}

int pat_residuals_mixed_out(const void* f0, const void* f1, const void* f2, const void* f3, const void* f4,
                            const void* f5, const void* f6, const void* f7, const void* f8, const void* f9,
                            const void* f10, const void* f11, void* o0, void* o1, void* o2, void* o3,
                            int nx, int ny, int nz, int periodic, int upwind, float inv2dt, float inv2hx,
                            float inv2hy, float inv2hz, void* stream) {
  const void* f[12] = {f0, f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11};
  void* o[4] = {o0, o1, o2, o3};
  return residuals_low_out<float>(f, o, nx, ny, nz, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz, stream);
}

int pat_partials_finalize(const float* tile_parts, int ntiles, int nz, float* parts, float* loss,
                          float w_sigma, float w_u, float inv_n, void* stream) {
  k_partials_finalize<<<1, 256, 0, (cudaStream_t)stream>>>(tile_parts, ntiles, nz, parts, loss,
                                                           w_sigma, w_u, inv_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
