// The K-Planes encoder on a regular grid and its pull-back, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no K-Planes field. The port's
// plain version (models/kplanes.encode_grid_zcf_slices_plain) samples each
// plane at its axes' nodes and multiplies the six samples of a scale; its
// autograd graph would hold a [cells, F] tensor a plane and scale, 51.5 GB
// a slice at 256^3, so on the card these entry points compute the same
// function with no such tensor.
//
// What it computes (models/kplanes.py), for S slice times ts [S] and LF =
// scales x F features (feature f = l F + i of scale l):
//   node tables: every plane sampled at its axes' grid nodes (a time plane
//   at each slice's t): XY [LF, ny, nx], XZ [LF, nz, nx], YZ [LF, nz, ny],
//   XT [S, LF, nx], YT [S, LF, ny], ZT [S, LF, nz]; a sample is the lerp
//   along the plane's first axis, then along its second, each (1 - w) a +
//   w b, the positions ((c + 1) / 2) (r - 1) clamped to [0, r - 1] in
//   float32 (grid_sample, align_corners, border);
//   enc[s, z, f, y, x] = ((((XY XZ) XT_s) YZ) YT_s) ZT_s.
// Every step is one IEEE float32 operation in the plain ops' order (the
// _rn intrinsics keep the compiler from contracting them), so the encoding
// is the plain ops' bit for bit.
//
// The pull-back, from dEnc g_s [S, nz, LF, ny, nx]: with a = XY, b = XZ,
// c = YZ and the slice factors X_s, Y_s, Z_s, a cell's feature gives
//   G = sum_s g_s X_s Y_s Z_s:  dXY += G b c, dXZ += G a c, dYZ += G a b,
// and to the time points tau_lo + k (k < 3) of the three time planes,
// through each slice's time weights W_s[k] (the t lerp's (1 - w, w) at
// its two points; the slices t - dt .. t + dt lie within three points when
// 2 dt (T - 1) <= 0.9, which the host checks), with S_ = a b c:
//   HX_k += S_ sum_s W_s[k] g_s Y_s Z_s, HY_k += S_ sum_s W_s[k] g_s X_s Z_s,
//   HZ_k += S_ sum_s W_s[k] g_s X_s Y_s.
// The slices meet in each cell before any sum over cells: the t -+ dt legs
// are 1/(2 dt) times the t slice's and nearly cancel, and a float32 sum of
// each apart over the grid would lose that much more.
//   pass 1 (k_kp_pull_main): a block owns a feature, YC rows of y and up to
//     XC cells of x (a thread a column x) and walks every z: dXY complete;
//     dXZ, HX over its rows, dYZ, HY over its columns, HZ over both, as
//     partials (each sum in a fixed order: warp shuffles, then the warps in
//     order).
//   pass 2 (k_kp_pull_sum): the partials added in chunk order.
//   pass 3 (k_kp_unsample): a thread a plane point gathers the node
//     gradients of the nodes whose samples read it, in node order, through
//     the transposed lerps (a time plane: the three points of the window).
// No atomics anywhere: the same inputs give the same bits every run.
//
// Bound: memory. At 256^3 with LF = 128 and three slices the forward writes
// 25.8 GB of encoding and the pull-back reads as much (7.7 ms a direction
// at 3.35 TB/s); the node tables are 0.1 GB.

#include <cuda_runtime.h>

namespace {
namespace kp {

constexpr int MAXSC = 8;  // the most scales (models/kplanes.MAX_SCALES)
constexpr int NPL = 6;    // planes a scale: xy, xz, xt, yz, yt, zt
constexpr int NT = 256;   // threads of the node, encode, sum and unsample passes
constexpr int XC = 256;   // the main pass's threads: cells of x a block
constexpr int YC = 4;     // rows of y a block of the main pass (models/kplanes.PULL_YC)
constexpr int NW = XC / 32;

struct Planes {
  const float* p[MAXSC * NPL];
  int res[MAXSC];
};

struct Dims {
  int nx, ny, nz, nsc, F, LF, T, S;
  // offsets of the node tables in the nodes buffer
  __host__ __device__ long long o_xz() const { return (long long)LF * ny * nx; }
  __host__ __device__ long long o_yz() const { return o_xz() + (long long)LF * nz * nx; }
  __host__ __device__ long long o_xt() const { return o_yz() + (long long)LF * nz * ny; }
  __host__ __device__ long long o_yt() const { return o_xt() + (long long)S * LF * nx; }
  __host__ __device__ long long o_zt() const { return o_yt() + (long long)S * LF * ny; }
  __host__ __device__ long long n_nodes() const { return o_zt() + (long long)S * LF * nz; }
};

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, w), a), __fmul_rn(w, b));
}

struct Pos {
  int i0;
  float w;
};

// The lower point and the upper point's weight of coordinate c on an axis
// of r points (models/kplanes._position).
__device__ __forceinline__ Pos position(float c, int r) {
  float pos = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f), (float)(r - 1));
  pos = fminf(fmaxf(pos, 0.f), (float)(r - 1));
  const float i0 = fminf(floorf(pos), (float)(r - 2));
  return {(int)i0, __fsub_rn(pos, i0)};
}

// c = 2 u - 1 of node i of n, u = i / (n - 1) (models/kplanes._node_coords).
__device__ __forceinline__ float node_coord(int i, int n) {
  if (n <= 1) return -1.f;
  return __fsub_rn(__fmul_rn(2.f, __fdiv_rn((float)i, (float)(n - 1))), 1.f);
}

__device__ __forceinline__ float time_coord(float t) { return __fsub_rn(__fmul_rn(2.f, t), 1.f); }

// Plane p [F, rb, ra], feature i, sampled at coordinates (ca, cb).
__device__ __forceinline__ float sample(const float* __restrict__ p, int i, int rb, int ra, float ca, float cb) {
  const Pos pa = position(ca, ra), pb = position(cb, rb);
  const float* row = p + ((size_t)i * rb + pb.i0) * ra + pa.i0;
  const float r0 = lerp(__ldg(row), __ldg(row + 1), pa.w);
  const float r1 = lerp(__ldg(row + ra), __ldg(row + ra + 1), pa.w);
  return lerp(r0, r1, pb.w);
}

// The time window of the slices: its first point tlo and each slice's
// weights W[s][k] at points tlo + k (zero past S).
__device__ __forceinline__ void time_window(const float* __restrict__ ts, int S, int T, int& tlo, float (&W)[3][3]) {
  Pos p[3];
  tlo = T;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    p[s] = position(time_coord(s < S ? __ldg(ts + s) : 0.f), T);
    if (s < S) tlo = min(tlo, p[s].i0);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float v = 0.f;
      if (s < S) {
        if (p[s].i0 - tlo == k) v = __fsub_rn(1.f, p[s].w);
        if (p[s].i0 + 1 - tlo == k) v = p[s].w;
      }
      W[s][k] = v;
    }
}

// ---- forward ------------------------------------------------------------------

// The node tables, a thread an entry (the buffer's flat order).
__global__ void __launch_bounds__(NT) k_kp_nodes(Planes P, Dims d, const float* __restrict__ ts,
                                                 float* __restrict__ nodes) {
  const long long total = d.n_nodes();
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total; i += (long long)gridDim.x * NT) {
    long long j = i;
    int kind, f, na, nb, a, b, s = 0;  // plane kind (PLANES index), feature, node counts, node indices
    if (j < d.o_xz()) {
      kind = 0, na = d.nx, nb = d.ny;
    } else if (j < d.o_yz()) {
      j -= d.o_xz(), kind = 1, na = d.nx, nb = d.nz;
    } else if (j < d.o_xt()) {
      j -= d.o_yz(), kind = 3, na = d.ny, nb = d.nz;
    } else if (j < d.o_yt()) {
      j -= d.o_xt(), kind = 2, na = d.nx, nb = 1;
    } else if (j < d.o_zt()) {
      j -= d.o_yt(), kind = 4, na = d.ny, nb = 1;
    } else {
      j -= d.o_zt(), kind = 5, na = d.nz, nb = 1;
    }
    a = (int)(j % na);
    j /= na;
    if (kind == 0 || kind == 1 || kind == 3) {
      b = (int)(j % nb);
      f = (int)(j / nb);
    } else {
      b = 0;
      f = (int)(j % d.LF);
      s = (int)(j / d.LF);
    }
    const int l = f / d.F, fi = f % d.F, r = P.res[l];
    const float* p = P.p[l * NPL + kind];
    const float ca = node_coord(a, na);
    float v;
    if (kind == 0 || kind == 1 || kind == 3)
      v = sample(p, fi, r, r, ca, node_coord(b, nb));
    else
      v = sample(p, fi, d.T, r, ca, time_coord(__ldg(ts + s)));
    nodes[i] = v;
  }
}

// enc [S, nz, LF, ny, nx]: a thread a cell (y, x) of plane z and FB features,
// the features' loads unrolled so that they are in flight together.
constexpr int FB = 8;

__global__ void __launch_bounds__(NT) k_kp_encode(Dims d, const float* __restrict__ nodes, float* __restrict__ enc) {
  const long long plane = (long long)d.ny * d.nx;
  const long long cell = (long long)blockIdx.x * NT + threadIdx.x;
  if (cell >= plane) return;
  const int y = (int)(cell / d.nx), x = (int)(cell % d.nx), z = blockIdx.y;
  const int f0 = blockIdx.z * FB;
  const float* XY = nodes;
  const float* XZ = nodes + d.o_xz();
  const float* YZ = nodes + d.o_yz();
  const float* XT = nodes + d.o_xt();
  const float* YT = nodes + d.o_yt();
  const float* ZT = nodes + d.o_zt();
#pragma unroll
  for (int i = 0; i < FB; ++i) {
    const int f = f0 + i;
    if (f >= d.LF) break;
    const float p1 = __fmul_rn(__ldg(XY + f * plane + cell), __ldg(XZ + ((long long)f * d.nz + z) * d.nx + x));
    const float yz = __ldg(YZ + ((long long)f * d.nz + z) * d.ny + y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s >= d.S) break;
      const long long sf = (long long)s * d.LF + f;
      float v = __fmul_rn(p1, __ldg(XT + sf * d.nx + x));
      v = __fmul_rn(v, yz);
      v = __fmul_rn(v, __ldg(YT + sf * d.ny + y));
      v = __fmul_rn(v, __ldg(ZT + sf * d.nz + z));
      __stcs(enc + (((long long)s * d.nz + z) * d.LF + f) * plane + cell, v);
    }
  }
}

// ---- pull-back ----------------------------------------------------------------

// The scratch's parts (floats), in order: dXY [LF, ny, nx]; the partials
// pXZ [nyc, LF, nz, nx], pYZ [nxc, LF, nz, ny], pHX [nyc, LF, 3, nx], pHY
// [nxc, LF, 3, ny], pHZ [nyc nxc, LF, 3, nz]; their sums dXZ, dYZ, HX, HY,
// HZ (models/kplanes.pull_scratch_floats).
struct Scratch {
  float *dxy, *pxz, *pyz, *phx, *phy, *phz, *dxz, *dyz, *hx, *hy, *hz;
};

__host__ inline Scratch scratch_layout(float* base, const Dims& d, int nyc, int nxc) {
  Scratch s;
  const long long LF = d.LF;
  s.dxy = base;
  s.pxz = s.dxy + LF * d.ny * d.nx;
  s.pyz = s.pxz + (long long)nyc * LF * d.nz * d.nx;
  s.phx = s.pyz + (long long)nxc * LF * d.nz * d.ny;
  s.phy = s.phx + (long long)nyc * LF * 3 * d.nx;
  s.phz = s.phy + (long long)nxc * LF * 3 * d.ny;
  s.dxz = s.phz + (long long)nyc * nxc * LF * 3 * d.nz;
  s.dyz = s.dxz + LF * d.nz * d.nx;
  s.hx = s.dyz + LF * d.nz * d.ny;
  s.hy = s.hx + LF * 3 * d.nx;
  s.hz = s.hy + LF * 3 * d.ny;
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;  // in lane 0
}

// Pass 1: grid (LF, nyc, nxc), XC threads.
__global__ void __launch_bounds__(XC, 2)
    k_kp_pull_main(Dims d, const float* __restrict__ ts, const float* __restrict__ nodes,
                   const float* __restrict__ denc, Scratch sc, int nyc, int nxc) {
  __shared__ float sW[3][3];
  __shared__ float sYT[3][YC];
  __shared__ float red[NW][3 * YC + 3];
  const int f = blockIdx.x, yc = blockIdx.y, xc = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x = xc * XC + tid, y0 = yc * YC, nrow = min(YC, d.ny - y0);
  const bool xin = x < d.nx;
  const long long plane = (long long)d.ny * d.nx;
  const float* XY = nodes + f * plane;
  const float* XZ = nodes + d.o_xz() + (long long)f * d.nz * d.nx;
  const float* YZ = nodes + d.o_yz() + (long long)f * d.nz * d.ny;
  if (tid == 0) {
    int tlo;
    float W[3][3];
    time_window(ts, d.S, d.T, tlo, W);
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int k = 0; k < 3; ++k) sW[s][k] = W[s][k];
  }
  if (tid < 3 * YC) {
    const int s = tid / YC, yl = tid % YC;
    sYT[s][yl] = s < d.S && yl < nrow ? __ldg(nodes + d.o_yt() + ((long long)s * d.LF + f) * d.ny + y0 + yl) : 0.f;
  }
  float xyv[YC], acc_xy[YC], hy[YC][3], tx[3], hx[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int yl = 0; yl < YC; ++yl) {
    xyv[yl] = xin && yl < nrow ? __ldg(XY + (long long)(y0 + yl) * d.nx + x) : 0.f;
    acc_xy[yl] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) hy[yl][k] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
    tx[s] = xin && s < d.S ? __ldg(nodes + d.o_xt() + ((long long)s * d.LF + f) * d.nx + x) : 0.f;
  __syncthreads();  // pull: weights and YT in
  float W[3][3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int k = 0; k < 3; ++k) W[s][k] = sW[s][k];

  for (int z = 0; z < d.nz; ++z) {
    const float xz = xin ? __ldg(XZ + (long long)z * d.nx + x) : 0.f;
    float tz[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) tz[s] = s < d.S ? __ldg(nodes + d.o_zt() + ((long long)s * d.LF + f) * d.nz + z) : 0.f;
    float acc_xz = 0.f, hz[3] = {0.f, 0.f, 0.f}, vv[YC];
    // every row's cotangents first, with no branch between them, so that
    // they are in flight together (a row past ny reads zeros)
    float gz[YC][3], yzv[YC];
#pragma unroll
    for (int yl = 0; yl < YC; ++yl) {
      yzv[yl] = yl < nrow ? __ldg(YZ + (long long)z * d.ny + y0 + yl) : 0.f;
#pragma unroll
      for (int s = 0; s < 3; ++s)
        gz[yl][s] = xin && s < d.S && yl < nrow
                        ? __ldcs(denc + (((long long)s * d.nz + z) * d.LF + f) * plane + (long long)(y0 + yl) * d.nx + x)
                        : 0.f;
    }
#pragma unroll
    for (int yl = 0; yl < YC; ++yl) {
      {
        const float yz = yzv[yl];
        const float g[3] = {gz[yl][0], gz[yl][1], gz[yl][2]};
        const float a = xyv[yl], ab = a * xz, sv = ab * yz;
        float G = 0.f, ux[3], uy[3], uz[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const float ty = sYT[s][yl], txy = tx[s] * ty;
          G = fmaf(g[s], txy * tz[s], G);
          ux[s] = g[s] * (ty * tz[s]);
          uy[s] = g[s] * (tx[s] * tz[s]);
          uz[s] = g[s] * txy;
        }
        acc_xy[yl] = fmaf(G, xz * yz, acc_xy[yl]);
        acc_xz = fmaf(G, a * yz, acc_xz);
        vv[yl] = G * ab;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          hx[k] = fmaf(sv, fmaf(W[2][k], ux[2], fmaf(W[1][k], ux[1], W[0][k] * ux[0])), hx[k]);
          hy[yl][k] = fmaf(sv, fmaf(W[2][k], uy[2], fmaf(W[1][k], uy[1], W[0][k] * uy[0])), hy[yl][k]);
          hz[k] = fmaf(sv, fmaf(W[2][k], uz[2], fmaf(W[1][k], uz[1], W[0][k] * uz[0])), hz[k]);
        }
      }
    }
    if (xin) sc.pxz[(((long long)yc * d.LF + f) * d.nz + z) * d.nx + x] = acc_xz;
    // dYZ of the rows and HZ: over this block's columns
#pragma unroll
    for (int yl = 0; yl < YC; ++yl) vv[yl] = warp_sum(vv[yl]);
#pragma unroll
    for (int k = 0; k < 3; ++k) hz[k] = warp_sum(hz[k]);
    if (lane == 0) {
#pragma unroll
      for (int yl = 0; yl < YC; ++yl) red[warp][yl] = vv[yl];
#pragma unroll
      for (int k = 0; k < 3; ++k) red[warp][YC + k] = hz[k];
    }
    __syncthreads();  // pull: the warps' sums in
    if (tid < YC + 3) {
      float v = 0.f;
      for (int w = 0; w < NW; ++w) v = __fadd_rn(v, red[w][tid]);
      if (tid < YC) {
        if (tid < nrow) sc.pyz[(((long long)xc * d.LF + f) * d.nz + z) * d.ny + y0 + tid] = v;
      } else {
        const int k = tid - YC;
        sc.phz[((((long long)yc * nxc + xc) * d.LF + f) * 3 + k) * d.nz + z] = v;
      }
    }
    __syncthreads();  // pull: red free again
  }
  // dXY (all of z: complete) and HX (partial over the chunks of y)
#pragma unroll
  for (int yl = 0; yl < YC; ++yl)
    if (xin && yl < nrow) sc.dxy[((long long)f * d.ny + y0 + yl) * d.nx + x] = acc_xy[yl];
  if (xin) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sc.phx[(((long long)yc * d.LF + f) * 3 + k) * d.nx + x] = hx[k];
  }
  // HY: over this block's columns
#pragma unroll
  for (int yl = 0; yl < YC; ++yl)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = warp_sum(hy[yl][k]);
      if (lane == 0) red[warp][yl * 3 + k] = v;
    }
  __syncthreads();  // pull: the warps' HY sums in
  if (tid < 3 * YC) {
    const int yl = tid / 3, k = tid % 3;
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v = __fadd_rn(v, red[w][tid]);
    if (yl < nrow) sc.phy[(((long long)xc * d.LF + f) * 3 + k) * d.ny + y0 + yl] = v;
  }
}

// out[i] = sum over c < nc of part[c n + i], c in order.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ part, long long n, int nc, long long i) {
  float v = 0.f;
  for (int c = 0; c < nc; ++c) v = __fadd_rn(v, __ldg(part + (long long)c * n + i));
  return v;
}

// Pass 2: dXZ, dYZ, HX, HY, HZ from their partials, a thread an output.
__global__ void __launch_bounds__(NT) k_kp_pull_sum(Dims d, Scratch sc, int nyc, int nxc) {
  const long long LF = d.LF;
  const long long n_xz = LF * d.nz * d.nx, n_yz = LF * d.nz * d.ny, n_hx = LF * 3 * d.nx, n_hy = LF * 3 * d.ny,
                  n_hz = LF * 3 * d.nz;
  const long long total = n_xz + n_yz + n_hx + n_hy + n_hz;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total; i += (long long)gridDim.x * NT) {
    long long j = i;
    if (j < n_xz) {
      sc.dxz[j] = chunk_sum(sc.pxz, n_xz, nyc, j);
      continue;
    }
    j -= n_xz;
    if (j < n_yz) {
      sc.dyz[j] = chunk_sum(sc.pyz, n_yz, nxc, j);
      continue;
    }
    j -= n_yz;
    if (j < n_hx) {
      sc.hx[j] = chunk_sum(sc.phx, n_hx, nyc, j);
      continue;
    }
    j -= n_hx;
    if (j < n_hy) {
      sc.hy[j] = chunk_sum(sc.phy, n_hy, nxc, j);
      continue;
    }
    j -= n_hy;
    sc.hz[j] = chunk_sum(sc.phz, n_hz, nyc * nxc, j);
  }
}

// The transposed lerp of point i of an axis of r points from nodes of n:
// sum over the nodes m whose sample reads point i (in node order) of the
// node's weight at i times v(m).
template <class V>
__device__ __forceinline__ float gather_axis(int i, int r, int n, V v) {
  long long lo = 0, hi = 0;
  if (n > 1) {
    lo = max(0LL, (long long)(i - 1) * (n - 1) / (r - 1) - 1);
    hi = min((long long)n - 1, ((long long)(i + 1) * (n - 1) + r - 2) / (r - 1) + 1);
  }
  float acc = 0.f;
  for (long long m = lo; m <= hi; ++m) {
    const Pos p = position(node_coord((int)m, n), r);
    if (p.i0 == i)
      acc = fmaf(__fsub_rn(1.f, p.w), v((int)m), acc);
    else if (p.i0 + 1 == i)
      acc = fmaf(p.w, v((int)m), acc);
  }
  return acc;
}

// Pass 3: every plane's gradient (the flat buffer in models/kplanes.
// planes_list's order), a thread a point.
__global__ void __launch_bounds__(NT) k_kp_unsample(Planes P, Dims d, const float* __restrict__ ts, Scratch sc,
                                                    float* __restrict__ grad, long long total) {
  int tlo;
  float W[3][3];
  time_window(ts, d.S, d.T, tlo, W);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total; i += (long long)gridDim.x * NT) {
    // find the plane
    long long j = i;
    int l = 0, kind = 0, ra = 0, rb = 0;
    for (l = 0; l < d.nsc; ++l) {
      const int r = P.res[l];
      bool found = false;
      for (kind = 0; kind < NPL; ++kind) {
        const bool timed = kind == 2 || kind == 4 || kind == 5;
        const long long size = (long long)d.F * (timed ? d.T : r) * r;
        if (j < size) {
          found = true;
          break;
        }
        j -= size;
      }
      if (found) break;
    }
    const int r = P.res[l];
    const bool timed = kind == 2 || kind == 4 || kind == 5;
    ra = r;
    rb = timed ? d.T : r;
    const int ia = (int)(j % ra), jb = (int)((j / ra) % rb), fi = (int)(j / ((long long)ra * rb));
    const long long f = (long long)l * d.F + fi;
    float v = 0.f;
    if (!timed) {
      // node gradient D [nb][na]
      const float* D;
      int na, nb;
      if (kind == 0) {
        D = sc.dxy + f * d.ny * d.nx, na = d.nx, nb = d.ny;
      } else if (kind == 1) {
        D = sc.dxz + f * d.nz * d.nx, na = d.nx, nb = d.nz;
      } else {
        D = sc.dyz + f * d.nz * d.ny, na = d.ny, nb = d.nz;
      }
      v = gather_axis(jb, rb, nb, [&](int m) {
        return gather_axis(ia, ra, na, [&](int n) { return __ldg(D + (long long)m * na + n); });
      });
    } else {
      const int k = jb - tlo;
      if (k >= 0 && k < 3) {
        const float* H;
        int na;
        if (kind == 2) {
          H = sc.hx + (f * 3 + k) * d.nx, na = d.nx;
        } else if (kind == 4) {
          H = sc.hy + (f * 3 + k) * d.ny, na = d.ny;
        } else {
          H = sc.hz + (f * 3 + k) * d.nz, na = d.nz;
        }
        v = gather_axis(ia, ra, na, [&](int n) { return __ldg(H + n); });
      }
    }
    grad[i] = v;
  }
}

__host__ inline int grid_blocks(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (int)(b < 132LL * 16 ? (b > 0 ? b : 1) : 132LL * 16);
}

__host__ inline bool make_planes(const long long* planes, const int* res, int nsc, Planes& P) {
  if (nsc < 1 || nsc > MAXSC) return false;
  for (int l = 0; l < nsc; ++l) {
    if (res[l] < 2) return false;
    P.res[l] = res[l];
    for (int k = 0; k < NPL; ++k) P.p[l * NPL + k] = planes ? reinterpret_cast<const float*>(planes[l * NPL + k]) : nullptr;
  }
  return true;
}

}  // namespace kp
}  // namespace

extern "C" {

// planes: a host array of the scales x 6 plane pointers (scale-major, the
// PLANES order); res: a host array of the scales' spatial resolutions; ts
// [S] on the device; nodes: the node tables out; enc [S, nz, LF, ny, nx] out.
int pat_kplanes_encode(const long long* planes, const int* res, int nsc, int T, int F, const float* ts, int S,
                       float* nodes, float* enc, int nx, int ny, int nz, void* stream) {
  kp::Planes P{};
  if (!kp::make_planes(planes, res, nsc, P) || T < 2 || F < 1 || S < 1 || S > 3 || nx < 1 || ny < 1 || nz < 1 ||
      (long long)ny * nx > (1LL << 31) - kp::NT)
    return (int)cudaErrorInvalidValue;
  const kp::Dims d{nx, ny, nz, nsc, F, nsc * F, T, S};
  const cudaStream_t s = (cudaStream_t)stream;
  kp::k_kp_nodes<<<kp::grid_blocks(d.n_nodes()), kp::NT, 0, s>>>(P, d, ts, nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((long long)ny * nx + kp::NT - 1) / kp::NT), nz, (d.LF + kp::FB - 1) / kp::FB);
  kp::k_kp_encode<<<grid, kp::NT, 0, s>>>(d, nodes, enc);
  return (int)cudaGetLastError();
}

// res: as above; nodes: the forward's node tables; denc [S, nz, LF, ny,
// nx]; scratch: models/kplanes.pull_scratch_floats floats; grad: every
// plane's gradient, flat, in the planes' order.
int pat_kplanes_pullback(const int* res, int nsc, int T, int F, const float* ts, int S, const float* nodes,
                         const float* denc, float* scratch, float* grad, int nx, int ny, int nz, void* stream) {
  kp::Planes P{};
  if (!kp::make_planes(nullptr, res, nsc, P) || T < 2 || F < 1 || S < 1 || S > 3 || nx < 1 || ny < 1 || nz < 1)
    return (int)cudaErrorInvalidValue;
  const kp::Dims d{nx, ny, nz, nsc, F, nsc * F, T, S};
  const int nyc = (ny + kp::YC - 1) / kp::YC, nxc = (nx + kp::XC - 1) / kp::XC;
  const kp::Scratch sc = kp::scratch_layout(scratch, d, nyc, nxc);
  const cudaStream_t s = (cudaStream_t)stream;
  kp::k_kp_pull_main<<<dim3(d.LF, nyc, nxc), kp::XC, 0, s>>>(d, ts, nodes, denc, sc, nyc, nxc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long LF = d.LF;
  const long long nsum = LF * nz * (nx + ny) + LF * 3 * (nx + ny + nz);
  kp::k_kp_pull_sum<<<kp::grid_blocks(nsum), kp::NT, 0, s>>>(d, sc, nyc, nxc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long total = 0;
  for (int l = 0; l < nsc; ++l) total += (long long)F * res[l] * (3LL * res[l] + 3LL * T);
  kp::k_kp_unsample<<<kp::grid_blocks(total), kp::NT, 0, s>>>(P, d, ts, sc, grad, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
