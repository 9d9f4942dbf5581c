// The hash grid encoder on a regular grid and its pull-back, sm_90a.
//
// Replaces no TPU kernel: the JAX package runs the grid encoder
// (phys_autodiff_tpu/models/hash_encoder.py encode_grid_zcf) in XLA, as
// three resampling matmuls a level. The port's plain version
// (models/hash_encoder.encode_grid_zcf_plain) runs the same matmuls with
// [r+1, n] matrices of two nonzeros a column, movedim copies between them
// and a cat of the levels, and their transposes in the pull-back: some 200
// launches and 390 GFLOP a step at 256^3 for 5.9 GFLOP of lerps. These two
// entry points compute the same function from the same weights.
//
// What it computes (models/hash_encoder._EncodeKernel), for L levels of
// F = 2 features, level l of resolution r and corner lattice
// c [r+1, r+1, r+1, 2] (z, y, x, feature: a dense level's parameter grid as
// stored, a hashed level's gathered corners):
//   enc[k, 2l + f, y, x] = lerp_x(lerp_y(lerp_z(c)))
// the z lerp first, then y, then x, each lerp a * w0 + b * w1 of the two
// lattice samples that the resampling matrix's column holds (i0 and
// i0 + 1, weights m[i0], m[i0 + 1], read from the matrix itself on the
// host, so these are the matmuls' bits). Row k is the grid's z row rows[k]
// (the rows form: the z taps are those of the matrix's columns rows).
// The pull-back is the transposed graph: dEnc reduced over x, then y, per
// row k (pass A, into a [r+1, r+1, 2] plane a level and row), then the
// planes over z into each level's gradient (pass B). Every sum runs over
// the CSR list of a lattice index's nonzero weights in ascending grid
// order: a fixed order and no atomics, so the same inputs give the same
// bits every run. FAST is the bf16 tiers' encode (_ResampleBf16): each
// pass's input, and in the pull-back each pass's incoming cotangent, is
// rounded to bf16 (the weights come rounded from the host), with float32
// sums.
//
// Bound on this card: memory. The forward writes the encoding (4 * 2 L
// bytes a cell) and reads the lattices; the pull-back reads dEnc and
// writes the gradients. At 256^3 with Instant-NGP's 16 levels that is
// 2.15 GB of encoding and 0.32 GB of lattices each way, 0.74 ms at
// 3.35 TB/s a direction; 7 lerps a feature and cell is 1.9 GFLOP, 0.03 ms.
//
// Design:
//   - Forward (k_hash_encode): one launch for every level; a thread owns
//     a column x of YS output rows of one (row, level) plane, neighbouring
//     threads neighbouring columns, so the stores are coalesced and the
//     corners (one float2 each) come through L1; walking y it keeps the
//     z lerps of its two lattice rows and reads a lattice row only when
//     the y tap moves on. The taps of each axis are tables [L, n] of
//     (i0, w0, w1).
//   - Pass A (k_hash_pull_planes): a block owns a tile of lattice rows
//     [ia, ib) of one level in kb rows k, and walks the dEnc rows their y
//     lists read, CHUNK rows of both features at a time: it stages the
//     chunk in shared memory x-major (SDS apart, so the staging stores hit
//     distinct banks), reduces it over each lattice column's x list
//     (Q [2, r+1, CHUNK], CS apart, odd, so lanes over j read distinct
//     banks), and pushes each chunk row, in ascending y, into the lattice
//     rows of its two y taps in the tile's plane in shared memory (a
//     thread a column: no search, no race). The next chunk's loads (16 B
//     each, 64 B a thread) are in flight while a chunk is reduced. dEnc is
//     read from device memory once (a row that two tiles share is read
//     twice, through L2); the plane is written coalesced.
//   - Pass B (k_hash_pull_z): a block owns 256 lattice points (i, j) of a
//     level and a run of lattice planes iz, and sums for each the planes of
//     its z list (rows k), reading the scratch coalesced and writing the
//     gradient once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 64;  // models/hash_encoder.py _MAX_LEVELS
constexpr int NT = 256;         // threads a block, every kernel
constexpr int YS = 8;           // output rows a forward thread walks
constexpr int CHUNK = 8;        // dEnc rows pass A stages at a time
constexpr int SDS = CHUNK + 2;  // a staged column's stride in shared memory (_STAGE_STRIDE)
constexpr int CS = CHUNK + 1;   // Q's (odd: lanes over j read distinct banks; _Q_STRIDE)
constexpr int PF = 4;           // float4 a thread holds of the next chunk (a chunk of 2 x 8 x 256 floats)

// A level's row of the table `meta` (models/hash_encoder._plan_arrays):
// r, the offsets of its x, y and z CSR row pointers in `cptr`, of its
// [r+1, r+1, 2] plane in a scratch row and of its gradient in `grad`.
enum { M_R, M_XPTR, M_YPTR, M_ZPTR, M_PLANE, M_GRAD, M_STRIDE = 8 };

struct Corners {
  const float2* p[MAX_LEVELS];
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// a * w.x + b * w.y: the first tap's product, the second's fused onto it
// (the matmul's own order). FAST rounds the pass's inputs: the products of
// bf16 values are exact in float32, so the sum rounds once, as the bf16
// matmul's does.
template <bool FAST>
__device__ __forceinline__ float lerp(float a, float b, float2 w) {
  if (FAST) {
    a = bf16_round(a);
    b = bf16_round(b);
  }
  return __fmaf_rn(b, w.y, __fmul_rn(a, w.x));
}

template <bool FAST>
__device__ __forceinline__ float2 lerp2(float2 a, float2 b, float2 w) {
  return make_float2(lerp<FAST>(a.x, b.x, w), lerp<FAST>(a.y, b.y, w));
}

// enc [K, 2 L, ny, nx]. Taps (ti, tw): z [L, K], then y [L, ny], then x
// [L, nx]. Grid: (column blocks, L, K); thread g of the flattened grid
// owns column g % nx of the YS rows from (g / nx) YS: it keeps the z lerps
// of its lattice row iy and of iy + 1 from one output row to the next and
// reads only the lattice row that a step of iy brings in (the same values
// as recomputed: each is one lerp of the same corners).
template <bool FAST>
__global__ void __launch_bounds__(NT)
    k_hash_encode(Corners c, const int* __restrict__ meta, const int* __restrict__ ti,
                  const float2* __restrict__ tw, float* __restrict__ out, int K, int ny, int nx, int L) {
  const int l = blockIdx.y, k = blockIdx.z;
  const int g = blockIdx.x * NT + threadIdx.x;
  const int x = g % nx, ya = (g / nx) * YS;
  if (ya >= ny) return;
  const int r1 = meta[l * M_STRIDE + M_R] + 1;
  const size_t sz = (size_t)r1 * r1;
  const int zt = l * K + k;
  const int* yi = ti + L * K + l * ny;
  const float2* yw = tw + L * K + l * ny;
  const float2 wx = tw[L * (K + ny) + l * nx + x];
  const float2 wz = tw[zt];
  const float2* cz = c.p[l] + (size_t)ti[zt] * sz + ti[L * (K + ny) + l * nx + x];
  const size_t plane = (size_t)ny * nx;
  float* o0 = out + ((size_t)k * 2 * L + 2 * l) * plane + x;
  float* o1 = o0 + plane;
  float2 lo0, lo1, hi0, hi1;  // z lerps at (iy, ix), (iy, ix + 1), (iy + 1, ix), (iy + 1, ix + 1)
  int iy = -2;
  for (int y = ya; y < min(ny, ya + YS); ++y) {
    const int iyn = yi[y];
    if (iyn == iy + 1) {
      lo0 = hi0;
      lo1 = hi1;
    } else if (iyn != iy) {
      const float2* b = cz + (size_t)iyn * r1;
      lo0 = lerp2<FAST>(b[0], b[sz], wz);
      lo1 = lerp2<FAST>(b[1], b[sz + 1], wz);
    }
    if (iyn != iy) {
      const float2* b = cz + (size_t)(iyn + 1) * r1;
      hi0 = lerp2<FAST>(b[0], b[sz], wz);
      hi1 = lerp2<FAST>(b[1], b[sz + 1], wz);
      iy = iyn;
    }
    const float2 wy = yw[y];
    const float2 q0 = lerp2<FAST>(lo0, hi0, wy);
    const float2 q1 = lerp2<FAST>(lo1, hi1, wy);
    const float2 v = lerp2<FAST>(q0, q1, wx);
    o0[(size_t)y * nx] = v.x;
    o1[(size_t)y * nx] = v.y;
  }
}

// A chunk of dEnc: rows [c0, c0 + nc) (nc <= CHUNK) of both features,
// staged x-major in shared memory, sd [2][nx][SDS]. Element e of a feature
// is row e % CHUNK (rows from nc on are skipped) of column e / CHUNK, a
// float4 when nx % 4 == 0, else a float: the 8 lanes of a column write 8
// consecutive banks, a warp's 4 columns (4 SDS apart) the other 24.
// Registers hold a thread's first PF / 2 float4 (or 2 PF floats) of each
// feature, which covers nx <= 256; chunk_store loads any more directly.
constexpr int HALF = PF / 2;

__device__ __forceinline__ float get_lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int q, float a) {
  if (q == 0) v.x = a;
  if (q == 1) v.y = a;
  if (q == 2) v.z = a;
  if (q == 3) v.w = a;
}

template <bool VEC>
__device__ __forceinline__ void chunk_load(float4 (&pf)[PF], const float* d, size_t plane, int c0, int nc, int nx) {
  const int ncol = VEC ? nx >> 2 : nx;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int u = 0; u < (VEC ? HALF : 4 * HALF); ++u) {
      const int e = threadIdx.x + u * NT, yy = e & (CHUNK - 1), col = e / CHUNK;
      if (col < ncol && yy < nc) {
        const float* src = d + f * plane + (size_t)(c0 + yy) * nx;
        if (VEC) {
          pf[f * HALF + u] = *reinterpret_cast<const float4*>(src + 4 * col);
        } else {
          set_lane(pf[f * HALF + (u >> 2)], u & 3, src[col]);
        }
      }
    }
  }
}

template <bool FAST>
__device__ __forceinline__ void chunk_put(float* s, float v) {
  *s = FAST ? bf16_round(v) : v;
}

template <bool FAST, bool VEC>
__device__ __forceinline__ void chunk_store(const float4 (&pf)[PF], float* sd, const float* d, size_t plane, int c0,
                                            int nc, int nx) {
  constexpr int W = VEC ? 4 : 1, U = VEC ? HALF : 4 * HALF;
  const int ncol = nx / W;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    float* sf = sd + f * nx * SDS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * NT, yy = e & (CHUNK - 1), col = e / CHUNK;
      if (col < ncol && yy < nc) {
        float* s = sf + W * col * SDS + yy;
        if (VEC) {
          const float4 v = pf[f * HALF + u];
          chunk_put<FAST>(s, v.x);
          chunk_put<FAST>(s + SDS, v.y);
          chunk_put<FAST>(s + 2 * SDS, v.z);
          chunk_put<FAST>(s + 3 * SDS, v.w);
        } else {
          chunk_put<FAST>(s, get_lane(pf[f * HALF + (u >> 2)], u & 3));
        }
      }
    }
    for (int e = threadIdx.x + U * NT; e < CHUNK * ncol; e += NT) {
      const int yy = e & (CHUNK - 1), col = e / CHUNK;
      if (yy < nc) {
        const float* src = d + f * plane + (size_t)(c0 + yy) * nx + W * col;
        for (int q = 0; q < W; ++q) chunk_put<FAST>(sf + (W * col + q) * SDS + yy, src[q]);
      }
    }
  }
}

// Pass A. A tile (tiles [8] a block: level, ia, ib, y0, y1, 3 spare) is the
// lattice rows [ia, ib) of one level, whose y lists read the dEnc rows
// [y0, y1). Grid: (tiles, row blocks): a block takes the tile in rows
// [kb * blockIdx.y, + kb), one stream of chunks (each row's chunks in
// order). Shared memory: the staged chunk sd [2][nx][SDS], Q [2][r1][CS],
// then the tile's plane acc [(ib - ia) r1] of float2. Each chunk: stored
// from the registers, a barrier, the next chunk's loads issued, Q over x
// (thread tid: rows tid % 4 and tid % 4 + 4 of the columns tid / 4 + 64 m,
// one load of each weight for both), a barrier,
// then each thread adds to its own columns j of the plane the chunk's rows
// in ascending y, each row y to the lattice rows of its two y taps (a tap
// of weight 0 is no term of the y list): the y list's terms in its order,
// with no search. A row's last chunk writes its plane out. The next
// chunk's store waits for no barrier: sd was last read before the second,
// and sq is next written after the first; only a column's thread touches
// it in acc.
template <bool FAST>
__global__ void __launch_bounds__(NT, 3)
    k_hash_pull_planes(const float* __restrict__ denc, const int* __restrict__ meta, const int* __restrict__ tiles,
                       const int* __restrict__ ti, const float2* __restrict__ tw, const int* __restrict__ cptr,
                       const int* __restrict__ cidx, const float* __restrict__ cw, float* __restrict__ planes, int K,
                       int L, int ny, int nx, int row_floats, int kb) {
  extern __shared__ float smem[];
  const int* t = tiles + blockIdx.x * 8;
  const int l = t[0], ia = t[1], ib = t[2], y0 = t[3], y1 = t[4];
  const int* m = meta + l * M_STRIDE;
  const int r1 = m[M_R] + 1;
  const int* xp = cptr + m[M_XPTR];
  const int* yi = ti + L * K + l * ny;
  const float2* yw = tw + L * K + l * ny;
  float* sd = smem;
  float* sq = smem + 2 * nx * SDS;
  float2* acc = reinterpret_cast<float2*>(sq + 2 * r1 * CS + ((2 * r1 * CS) & 1));
  const int nout = (ib - ia) * r1;
  const size_t plane = (size_t)ny * nx;
  const bool vec = (nx & 3) == 0;
  const int k0 = blockIdx.y * kb, k1 = min(K, k0 + kb);
  const float* dl = denc + 2 * (size_t)l * plane;  // row k's features at dl + k row
  const size_t row = 2 * (size_t)L * plane;
  float2* out0 = reinterpret_cast<float2*>(planes + m[M_PLANE]) + (size_t)ia * r1;
  for (int e = threadIdx.x; e < nout; e += NT) acc[e] = make_float2(0.f, 0.f);
  if (y0 == y1) {  // no dEnc row reaches these lattice rows: zero planes
    for (int k = k0; k < k1; ++k)
      for (int e = threadIdx.x; e < nout; e += NT) out0[(size_t)k * (row_floats / 2) + e] = acc[e];
    return;
  }
  float4 pf[PF];
  int k = k0, c0 = y0;
  if (k < k1) {
    if (vec) {
      chunk_load<true>(pf, dl + k * row, plane, c0, min(CHUNK, y1 - c0), nx);
    } else {
      chunk_load<false>(pf, dl + k * row, plane, c0, min(CHUNK, y1 - c0), nx);
    }
  }
  while (k < k1) {
    const int nc = min(CHUNK, y1 - c0);
    if (vec) {
      chunk_store<FAST, true>(pf, sd, dl + k * row, plane, c0, nc, nx);
    } else {
      chunk_store<FAST, false>(pf, sd, dl + k * row, plane, c0, nc, nx);
    }
    __syncthreads();
    const bool last = c0 + CHUNK >= y1;  // the row's last chunk
    const int kn = last ? k + 1 : k, cn = last ? y0 : c0 + CHUNK;
    if (kn < k1) {
      if (vec) {
        chunk_load<true>(pf, dl + kn * row, plane, cn, min(CHUNK, y1 - cn), nx);
      } else {
        chunk_load<false>(pf, dl + kn * row, plane, cn, min(CHUNK, y1 - cn), nx);
      }
    }
    // over x: Q[f][j][yy], the terms of X(j) in ascending x
    const int yq = threadIdx.x & 3;
    if (yq < nc) {
      for (int j = threadIdx.x >> 2; j < r1; j += NT / 4) {
        const int p0 = xp[j], p1 = xp[j + 1];
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
        if (p0 < p1) {
          const float* s0 = sd + cidx[p0] * SDS + yq;
          for (int p = p0; p < p1; ++p, s0 += SDS) {
            const float w = cw[p];
            a0 = __fmaf_rn(s0[0], w, a0);
            a1 = __fmaf_rn(s0[nx * SDS], w, a1);
            b0 = __fmaf_rn(s0[4], w, b0);
            b1 = __fmaf_rn(s0[nx * SDS + 4], w, b1);
          }
        }
        sq[j * CS + yq] = FAST ? bf16_round(a0) : a0;
        sq[(r1 + j) * CS + yq] = FAST ? bf16_round(a1) : a1;
        if (yq + 4 < nc) {
          sq[j * CS + yq + 4] = FAST ? bf16_round(b0) : b0;
          sq[(r1 + j) * CS + yq + 4] = FAST ? bf16_round(b1) : b1;
        }
      }
    }
    __syncthreads();
    // over y: the chunk's rows into the thread's columns
    for (int j = threadIdx.x; j < r1; j += NT) {
      for (int r = 0; r < nc; ++r) {
        const int i = yi[c0 + r] - ia;
        const float2 w = yw[c0 + r];
        const float q0 = sq[j * CS + r], q1 = sq[(r1 + j) * CS + r];
        if (i >= 0 && i < ib - ia) {
          float2& a = acc[i * r1 + j];
          a.x = __fmaf_rn(q0, w.x, a.x);
          a.y = __fmaf_rn(q1, w.x, a.y);
        }
        if (w.y != 0.f && i + 1 >= 0 && i + 1 < ib - ia) {
          float2& a = acc[(i + 1) * r1 + j];
          a.x = __fmaf_rn(q0, w.y, a.x);
          a.y = __fmaf_rn(q1, w.y, a.y);
        }
      }
      if (last) {
        for (int i = 0; i < ib - ia; ++i) {
          out0[(size_t)k * (row_floats / 2) + i * r1 + j] = acc[i * r1 + j];
          acc[i * r1 + j] = make_float2(0.f, 0.f);
        }
      }
    }
    k = kn;
    c0 = cn;
  }
}

// Pass B. A tile (tiles [4] a block: level, e0, iz0, iz1) is the lattice
// points e0 .. e0 + 255 of a level's [r+1, r+1] plane and the lattice
// planes [iz0, iz1). grad[iz, e] sums the planes of Z(iz) in ascending k.
template <bool FAST>
__global__ void __launch_bounds__(NT)
    k_hash_pull_z(const float* __restrict__ planes, const int* __restrict__ meta, const int* __restrict__ tiles,
                  const int* __restrict__ cptr, const int* __restrict__ cidx, const float* __restrict__ cw,
                  float* __restrict__ grad, int row_floats) {
  const int* t = tiles + blockIdx.x * 4;
  const int l = t[0], iz0 = t[2], iz1 = t[3];
  const int* m = meta + l * M_STRIDE;
  const int r1 = m[M_R] + 1;
  const int e = t[1] + threadIdx.x;
  if (e >= r1 * r1) return;
  const int* zp = cptr + m[M_ZPTR];
  const float2* src = reinterpret_cast<const float2*>(planes + m[M_PLANE]) + e;
  const size_t rs = (size_t)(row_floats / 2);
  float2* dst = reinterpret_cast<float2*>(grad + m[M_GRAD]) + e;
  for (int iz = iz0; iz < iz1; ++iz) {
    float a0 = 0.f, a1 = 0.f;
    for (int p = zp[iz]; p < zp[iz + 1]; ++p) {
      float2 v = src[(size_t)cidx[p] * rs];
      if (FAST) {
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
      }
      a0 = __fmaf_rn(v.x, cw[p], a0);
      a1 = __fmaf_rn(v.y, cw[p], a1);
    }
    dst[(size_t)iz * r1 * r1] = make_float2(a0, a1);
  }
}

template <bool FAST>
int pullback(const float* denc, const int* meta, const int* ti, const float* tw, const int* tiles_a, int n_a,
             const int* tiles_b, int n_b, const int* cptr, const int* cidx, const float* cw, float* planes,
             float* grad, int K, int ny, int nx, int L, int row_floats, int kb, int smem_a, cudaStream_t s) {
  if (smem_a > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k_hash_pull_planes<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
    if (err != cudaSuccess) return (int)err;
  }
  k_hash_pull_planes<FAST><<<dim3(n_a, (K + kb - 1) / kb), NT, smem_a, s>>>(
      denc, meta, tiles_a, ti, reinterpret_cast<const float2*>(tw), cptr, cidx, cw, planes, K, L, ny, nx,
      row_floats, kb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_hash_pull_z<FAST><<<n_b, NT, 0, s>>>(planes, meta, tiles_b, cptr, cidx, cw, grad, row_floats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// corners: a host array of the L levels' lattice pointers.
int pat_hash_encode(const long long* corners, int L, const int* meta, const int* ti, const float* tw, float* out,
                    int K, int ny, int nx, int fast, void* stream) {
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Corners c{};
  for (int l = 0; l < L; ++l) c.p[l] = reinterpret_cast<const float2*>(corners[l]);
  const dim3 grid(((ny + YS - 1) / YS * nx + NT - 1) / NT, L, K);
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* w = reinterpret_cast<const float2*>(tw);
  if (fast) {
    k_hash_encode<true><<<grid, NT, 0, s>>>(c, meta, ti, w, out, K, ny, nx, L);
  } else {
    k_hash_encode<false><<<grid, NT, 0, s>>>(c, meta, ti, w, out, K, ny, nx, L);
  }
  return (int)cudaGetLastError();
}

// dEnc [K, 2 L, ny, nx] -> each level's lattice gradient in grad, through
// the scratch planes [K, row_floats].
int pat_hash_encode_pullback(const float* denc, const int* meta, const int* ti, const float* tw, const int* tiles_a,
                             int n_a, const int* tiles_b, int n_b, const int* cptr, const int* cidx, const float* cw,
                             float* planes, float* grad, int K, int ny, int nx, int L, int row_floats, int kb,
                             int smem_a, int fast, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (fast) {
    return pullback<true>(denc, meta, ti, tw, tiles_a, n_a, tiles_b, n_b, cptr, cidx, cw, planes, grad, K, ny, nx, L,
                          row_floats, kb, smem_a, s);
  }
  return pullback<false>(denc, meta, ti, tw, tiles_a, n_a, tiles_b, n_b, cptr, cidx, cw, planes, grad, K, ny, nx, L,
                         row_floats, kb, smem_a, s);
}

}  // extern "C"
