// The bf16 tier of the tiled MLP core (mlp_head.cuh): layer 2 on the tensor
// cores, mma.sync with bf16 operands and float32 accumulation. Its forward
// (fwd_pass / fwd_rows / fields_chunk with the warps' AB rings, AbRing) is
// shared by K2 and K4's fields pass; K3 and K6 run forwards of their own in
// mega.cu and fit.cu with the same operands a value (ab_kstep's AB loads,
// W2's fragments of load_w2_frags), and K6's backward and K4's adjoint pass
// have walks of their own (fit.cu, mega_bwd.cu).
//
// What the tier computes (the TPU's bf16 tier, pallas/mlp.py:231-232,
// mega.py:155-170, mega_bwd.py:705-750, fit.py:128-190): layer 1 stays the
// float32 core's, a1 = max(AB + CD, 0) with one float32 add; then every
// operand of the three layer-2 contractions is rounded to bf16 (to nearest
// even) and the products are summed in float32 (the forward takes the max
// after the rounding, on bf16 pairs: the same values, as rounding is
// monotone and keeps 0):
//   y    = bf16(a1) . bf16(W2)            (K2, K3, K4's fields, K6)
//   dW2T = bf16(gy)^T . bf16(a1)          (K4, K6)
//   da1  = bf16(gy) . bf16(W2)^T          (K4, K6), dz1 = [a1 > 0] da1
// K2's bf16x3 splits W2 and a1 into bf16 hi + lo (lo = bf16(x - hi)) and
// adds hi.hi + lo.hi + hi.lo (pallas/mlp.py:233-235, 300-316).
//
// Fragments (PTX ISA, mma.m16n8k16 / m16n8k8 with .bf16; lane = 4 g + t):
//   A 16 x 16: {a0, a1, a2, a3} = rows g, g + 8, g, g + 8 x columns
//     2t + {0, 1}, 2t + {0, 1}, 2t + 8 + {0, 1}, 2t + 8 + {0, 1}
//   B 16 x 8:  {b0, b1} = rows (k) 2t + {0, 1}, 2t + 8 + {0, 1} x column g
//   C 16 x 8:  {c0, c1, c2, c3} = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
//   (m16n8k8: A {a0, a1} and B {b0} as the first half of the above.)
// A register holds two bf16, the lower column (or row) in the low 16 bits:
// pack2(lo, hi) = __floats2bfloat162_rn(lo, hi) (cvt.rn.bf16x2.f32 takes
// the HIGH element first; chip_smoke.py checks the packing on the card).
//
// Forward (cells on M): a warp takes 16 cells x 16 hidden units as one A
// fragment (a thread: cells g and g + 8, hidden units 2t + {0, 1, 8, 9}),
// W2 as the B fragment (16 hidden units x 8 outputs; read from shared
// memory, 8 B a lane a k-step, pre-packed by load_w2_frags). A thread reads
// AB at its two cells once a k-step for all of a group's rows and slices,
// so AB's reuse across rows and slices is the f32 core's. H pads to a
// multiple of 16 with zero AB, zero CD and zero weights (exact zeros). K2
// and K4's fields pass (fields_chunk, below) put two (row, slice) values in
// one accumulator of 16 cells x 8 outputs ([W2 | 0] and [0 | W2]) and
// stream AB through a ring in shared memory; K3 (mega.cu) keeps one value
// an accumulator and reads AB from device memory (ab_kstep). The result of
// a (cell, row, slice) is its own chain of k-steps from 0 in the same order
// whatever fragment row or column the value sits in, so K2, K3 and K4 give
// a field value the same bits (K3's loss equals K2 -> K1's).
//
// Backward (hidden units on M, cells on N and K): see fit.cu (K6) and
// mega_bwd.cu (K4's adjoint pass).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mlp_head.cuh"

namespace {  // internal linkage: each kernel source has its own copy
namespace mma16 {

using mlph::NT;
using mlph::NW;
using mlph::TX;
using mlph::TY;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Two floats rounded to bf16 (to nearest even) in one register, lo in the
// low 16 bits.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pack2(lo, hi) with each half replaced by max(half, 0): one bf16x2 max.
__device__ __forceinline__ uint32_t relu2(float lo, float hi) {
  const __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// bf16x3's low part of x: x - float(bf16(x)), exact in float32.
__device__ __forceinline__ float rest(float x) { return x - __bfloat162float(__float2bfloat16_rn(x)); }

// d += A B, m16n8k16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B, m16n8k8, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// ldmatrix (m8n8, b16): lanes 8 j .. 8 j + 7 give the row addresses of
// matrix j (16 bytes each); thread T gets, of matrix j, (row T / 4, columns
// 2 (T % 4), + 1), or with .trans (rows 2 (T % 4), + 1, column T / 4), the
// lower index in the low half. The x2 forms read lanes 0-15's addresses.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// (x2 by a shared-window address, for loops that step it themselves)
__device__ __forceinline__ void ldsm2_at(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm2_t_at(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  ldsm2_at(r, (unsigned)__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const void* p) {
  ldsm2_t_at(r, (unsigned)__cvta_generic_to_shared(p));
}

// AB of one k-step at one cell for this thread's four hidden units of an A
// fragment (h, h + 1, h + 8, h + 9 with h = 16 kb + 2t, fwd_tile's order):
// p points at AB[h] of the cell, one hidden unit a plane. A full k-step
// (every unit below H) loads all four; the last, partial one loads zeros
// past H.
__device__ __forceinline__ void ab_kstep(const float* __restrict__ p, size_t plane, int h, int H, bool full,
                                         float (&v)[4]) {
  const float* p8 = p + 8 * plane;
  if (full) {
    v[0] = __ldg(p), v[1] = __ldg(p + plane), v[2] = __ldg(p8), v[3] = __ldg(p8 + plane);
  } else {
    v[0] = h < H ? __ldg(p) : 0.f;
    v[1] = h + 1 < H ? __ldg(p + plane) : 0.f;
    v[2] = h + 8 < H ? __ldg(p8) : 0.f;
    v[3] = h + 9 < H ? __ldg(p8 + plane) : 0.f;
  }
}

// W2T [4][H] as layer 2's B fragments: w2f[kb * 32 + lane] = {b0, b1} of
// k-step kb (hidden units 16 kb + 2t + {0, 1} and + 8), output g; zero for
// g >= 4 and past H. LO: the low parts rest(W2) (bf16x3). 2 HP16 entries.
template <bool LO>
__device__ __forceinline__ void load_w2_frags(uint2* w2f, const float* __restrict__ w2t, int H, int HP16) {
  for (int i = threadIdx.x; i < 2 * HP16; i += NT) {
    const int g = (i & 31) >> 2, h = 16 * (i >> 5) + 2 * (i & 3);
    auto w = [&](int hh) {
      const float v = g < 4 && hh < H ? __ldg(w2t + g * H + hh) : 0.f;
      return LO ? rest(v) : v;
    };
    w2f[i] = make_uint2(pack2(w(h), w(h + 1)), pack2(w(h + 8), w(h + 9)));
  }
}

// ---- the forward of K2's bf16 tiers and K4's bf16 fields pass ------------
//
// A warp takes one tile row (32 cells) of a chunk's rows as two 16-cell
// tiles, one after the other; a tile's rows run in groups of R (fwd_rows),
// and a group is a pass over the k-steps (16 hidden units each) with one
// m16n8k16 per (row, slice) a k-step. What the design does on this card:
//  - Two (row, slice) values a C fragment: value v of a group (v = row x S
//    + slice) sums into fragment v / 2, the even one with B = [W2 | 0]
//    (outputs in columns 0-3), the odd one with B = [0 | W2] (columns 4-7).
//    Each value keeps its own chain of k-steps from 0 in order; its
//    partner's products add exact zeros to its columns (the card's
//    mma.sync returns C unchanged then: the held digests check it). A
//    thread keeps half the accumulators (24 at S = 3, ZF = 4), and every
//    lane holds real outputs, so all 32 store.
//  - AB in flight through shared memory: each warp streams the k-step slabs
//    of its tile row (16 hidden-unit planes x 16 cells) through a ring of
//    FW_NS stages by 16-byte cp.async, FW_NS - 1 k-steps ahead of its
//    products (AbRing; no block barrier: the ring is the warp's own; two
//    stages did as well as three or four on an H100). A plane of a
//    stage is FW_PS = 20 floats, so the four lanes of a cell, which read
//    hidden units 2t apart, meet distinct banks. Cells past nx and hidden
//    units past H land as zeros (cp.async's zero fill). Where the ring does
//    not fit beside the CD rows (ring_stages: it never costs a block its
//    second slot on an SM), or nx is not a multiple of 4 (the rows' 16-byte
//    alignment), the kernel is the RING = false instantiation: AB is read
//    from device memory at the top of each k-step, clamped to the grid,
//    with the same values.
//  - Fewer CUDA-core instructions a value: bf16 packs and clamps a pair in
//    one cvt.rn.relu.bf16x2.f32 (relu_pack2); bf16x3 takes float(hi) from
//    the packed register and lo = x - float(hi) (exact), two converts a pair.
// The values and their order are the parent's: a1 = max(AB + CD, 0) in one
// float32 add, bf16 operands, float32 sums, bf16x3 hi.hi, lo.hi, hi.lo.

constexpr int FW_PS = 20;             // floats a hidden-unit plane of a stage
constexpr int FW_STAGE = 16 * FW_PS;  // floats a stage (16 planes of 16 cells)
constexpr int FW_NS = 2;              // the ring's stages
constexpr size_t FW_STATIC = 372;     // the forward's static shared memory a block (fw_desc, fw_chans, fw_chunk)

// Shared memory of the rings of a block at depth ns (bytes).
__host__ __device__ inline size_t ring_bytes(int ns) { return (size_t)ns * NW * FW_STAGE * sizeof(float); }

// The ring's depth beside `fixed` bytes of dynamic shared memory and the
// FW_STATIC static ones (kernels/mlp.ring_stages mirrors it): FW_NS where
// the rings fit beside them without costing a block its second slot on an
// SM (or, where they alone keep one block an SM, within that block's
// share); else 0 (AB from device memory), as also where AB's rows are not
// 16-byte aligned (nx % 4 != 0).
__host__ inline int ring_stages(size_t fixed, int nx, const float* ab) {
  constexpr size_t TWO_BLOCKS = 115712;  // a block's share with two blocks an SM
  fixed += FW_STATIC;
  const size_t cap = fixed <= TWO_BLOCKS ? TWO_BLOCKS : (size_t)mlph::SMEM_LIMIT;
  if (nx % 4 != 0 || (size_t)ab % 16 != 0) return 0;
  return fixed + ring_bytes(FW_NS) <= cap ? FW_NS : 0;
}

// Two floats from the shared window (a 32-bit, 8-byte aligned address;
// ordered after the ring's cp.async wait, which is asm volatile too).
__device__ __forceinline__ float2 lds_f32x2(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// bf16(max(lo, 0)), bf16(max(hi, 0)) in one register (lo in the low half):
// cvt.rn.relu clamps the rounded value, and bf16(max(x, 0)) = max(bf16(x),
// 0) as rounding is monotone and keeps 0.
__device__ __forceinline__ uint32_t relu_pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// bf16x3's split of a pair: hi = pack2(x0, x1) and lo = pack2(x0 - hi0,
// x1 - hi1), float(hi) read off the packed register (a bf16 is the high
// half of its float32), x - float(hi) exact: rest() without its converts.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2(x0, x1);
  lo = pack2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// The invariants of a warp's ring for a chunk (ring_start writes them), and
// the channel map of fields_chunk's stores (the kernels write it): in
// shared memory, read where they are needed, so that the registers stay
// with the products and the stores' pointers are not picked by selects.
struct RingDesc {
  const float* row;  // AB at hidden unit 0, this warp's tile row, cell x0
  int plane;         // floats a hidden-unit plane of AB (nx ny)
  int cells;         // cells of the row from x0 to nx
  int H, nkb, ngr, ntile;
};
__shared__ RingDesc fw_desc[NW];
__shared__ float* fw_chans[12];
__shared__ mlph::Chunk fw_chunk;  // K4's chunk for fields_chunk (publish_chunk)
static_assert(sizeof(fw_desc) + sizeof(fw_chans) + sizeof(fw_chunk) == FW_STATIC,
              "FW_STATIC: the forward's static shared memory");

// The chunk into fw_chunk, for fields_chunk to read where it needs it: K4's
// fields pass, whose row frame takes more registers than K2's, spilled
// with the chunk in registers through the products (K2 keeps its own).
// Called between the barrier that ends the last chunk and the one that
// publishes this chunk's CD rows.
__device__ __forceinline__ void publish_chunk(const mlph::Chunk& c) {
  if (threadIdx.x == 0) fw_chunk = c;
}

// The kernel's channel map into fw_chans (thread 0, each entry by a
// compile-time index: a run-time index into the kernel parameter copies it
// to local memory). The chunk loop's first barrier publishes it.
__device__ __forceinline__ void set_chans(const mlph::Chans& out) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) fw_chans[k] = out.p[k];
  }
}

// A warp's stream of AB k-step slabs through its ring: the slabs of tile 0's
// passes (one a group of rows, each over the nkb k-steps), then tile 1's.
// Kept small: it lives in registers beside the accumulators.
struct AbRing {
  unsigned st;        // this lane's first copy's place in stage 0 (a shared-window address)
  const float* src;   // this lane's first copy of the next slab (null past the chunk's last)
  unsigned slot;      // the stage of the next k-step
  int kleft;          // the k-steps of the pass left to issue
  int hl;             // H less the next slab's first plane of this lane's first copy (0: past nx)
  int igr, im;        // the next slab's group and tile
  int plane;          // floats a hidden-unit plane of AB (nx ny)
  int cm;             // the tile the products read (the ring off: read from device memory)

  __device__ __forceinline__ const RingDesc& d() const { return fw_desc[threadIdx.x >> 5]; }

  // This lane's copy offset inside a stage (bytes): plane lane / 4, cells
  // 4 (lane % 4) .. + 3.
  __device__ __forceinline__ static unsigned lane_copy() {
    const int lane = threadIdx.x & 31;
    return 4 * ((lane >> 2) * FW_PS + 4 * (lane & 3));
  }

  // The start of a pass over tile im: this lane's source at k-step 0
  // (plane lane / 4, cells 4 (lane % 4) .. + 3) and how many of its
  // hidden units lie below H (none where its cells lie past nx); past the
  // chunk's last tile no source.
  __device__ __forceinline__ void pass() {
    const int lane = threadIdx.x & 31, pl = lane >> 2, xq = 4 * (lane & 3);
    const RingDesc& r = d();
    kleft = r.nkb;
    src = im < r.ntile ? r.row + (size_t)pl * plane + 16 * im + xq : nullptr;
    hl = 16 * im + xq < r.cells ? r.H - pl : 0;
  }

  // The next slab into stage islot: lane l copies planes l / 4 and 8 + l /
  // 4, cells 4 (l % 4) .. + 3, 16 bytes each (nx % 4 == 0: a row's copies
  // are aligned and lie wholly inside or past nx); past H or nx the copy
  // reads nothing and fills zeros. Past the chunk's last slab nothing is
  // copied (the group is empty). The source steps 16 planes a k-step and
  // restarts at each pass.
  __device__ __forceinline__ void issue(unsigned islot) {
    if (src) {
      const unsigned a = st + 4 * islot * FW_STAGE;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src), "r"(hl > 0 ? 16 : 0)
                   : "memory");
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a + 8 * FW_PS * 4),
                   "l"(src + (size_t)8 * plane), "r"(hl > 8 ? 16 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!src) return;  // past the chunk's last slab: it stays there
    if (--kleft == 0) {
      if (++igr == d().ngr) igr = 0, ++im;
      pass();
    } else {
      src += (size_t)16 * plane;
      hl -= 16;
    }
  }

  // The chunk's stream: tiles of groups passes each. Issues the first
  // FW_NS - 1 slabs (K2 and K4 call it before the barrier that publishes
  // the chunk's CD rows, so their latency hides behind the CD copy).
  __device__ __forceinline__ void start() {
    slot = 0, igr = 0, im = 0;
    plane = d().plane;
    pass();
#pragma unroll
    for (unsigned k = 0; k < FW_NS - 1; ++k) issue(k);
  }

  // The stage of the next k-step (its shared-window address plus this
  // lane's copy offset): waits for its slab, then issues the slab FW_NS -
  // 1 k-steps ahead into the stage the last k-step read.
  __device__ __forceinline__ unsigned next() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FW_NS - 2) : "memory");
    __syncwarp();  // every lane's copies of this slab in; the last slab's reads done
    const unsigned cur = st + 4 * slot * FW_STAGE;
    issue((slot + FW_NS - 1) % FW_NS);  // (unsigned: a mask for a power of two)
    slot = (slot + 1) % FW_NS;
    return cur;
  }
};

// One pass over the k-steps for R rows and S slices of one 16-cell tile
// (ring.cm): acc[v / 2] gets value v = zl * S + s in columns 4 (v % 2) ..
// + 3 (C fragment order: rows g, g + 8 x columns 2t, 2t + 1; fragment row
// g is the tile's cell 2g and row g + 8 its cell 2g + 1, so that a lane
// reads AB of its two cells in one 8-byte load and stores them in one),
// the sum over the k-steps of bf16(max(AB + CD, 0)) . bf16(W2) (X3: hi.hi
// + lo.hi + hi.lo). AB comes from the ring's stage, or with the ring off from device
// memory at the thread's cells clamped to the grid; cdv: the CD table, row
// zl's slice s of hidden unit h at cdv[h * stride + zl * rstride + s].
template <int S, int R, bool X3, bool RING>
__device__ __forceinline__ void fwd_pass(AbRing& ring, const uint2* w2f, const uint2* w2f_lo, const float* cdv,
                                         int stride, int rstride, float (&acc)[(R * S + 1) / 2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < (R * S + 1) / 2; ++f)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[f][k] = 0.f;
  const int nkb = ring.d().nkb;
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    int hs[4];
    float al[4], ah[4];
    const unsigned stg = RING ? ring.next() - ring.lane_copy() + 8 * g : 0u;  // this lane's cells 2g, 2g + 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 2 * t + (j & 1) + 8 * (j >> 1);  // the hidden unit within the k-step
      hs[j] = 16 * kb + u;
      if constexpr (RING) {
        const float2 v = lds_f32x2(stg + 4 * u * FW_PS);
        al[j] = v.x, ah[j] = v.y;
      } else {
        const RingDesc& r = ring.d();
        const bool on = hs[j] < r.H;
        const int last = r.cells - 1 - 16 * ring.cm;  // the tile's last cell inside the grid
        const float* p = r.row + (size_t)hs[j] * r.plane + 16 * ring.cm;
        al[j] = on ? __ldg(p + min(2 * g, last)) : 0.f;
        ah[j] = on ? __ldg(p + min(2 * g + 1, last)) : 0.f;
      }
    }
    const uint2 wa = w2f[kb * 32 + lane], wb = w2f[kb * 32 + (lane ^ 16)];
    uint2 la = wa, lb = wb;
    if constexpr (X3) la = w2f_lo[kb * 32 + lane], lb = w2f_lo[kb * 32 + (lane ^ 16)];
#pragma unroll
    for (int zl = 0; zl < R; ++zl) {
      float cv[4][S];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* row = cdv + hs[j] * stride + zl * rstride;
        if constexpr (S == 3) {  // an aligned row of the three slices
          const float4 q = *reinterpret_cast<const float4*>(row);
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int s = 0; s < S; ++s) cv[j][s] = qv[s];
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) cv[j][s] = row[s];
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int v = zl * S + s;
        const uint2 w = v & 1 ? wb : wa;
        float x[4], y[4];
        if constexpr (!X3) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = al[j] + cv[j][s];
            y[j] = ah[j] + cv[j][s];
          }
          mma16816(acc[v >> 1], relu_pack2(x[0], x[1]), relu_pack2(y[0], y[1]), relu_pack2(x[2], x[3]),
                   relu_pack2(y[2], y[3]), w.x, w.y);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = fmaxf(al[j] + cv[j][s], 0.f);
            y[j] = fmaxf(ah[j] + cv[j][s], 0.f);
          }
          uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
          split2(x[0], x[1], h0, l0);
          split2(y[0], y[1], h1, l1);
          split2(x[2], x[3], h2, l2);
          split2(y[2], y[3], h3, l3);
          const uint2 wl = v & 1 ? lb : la;
          mma16816(acc[v >> 1], h0, h1, h2, h3, w.x, w.y);
          mma16816(acc[v >> 1], l0, l1, l2, l3, w.x, w.y);
          mma16816(acc[v >> 1], h0, h1, h2, h3, wl.x, wl.y);
        }
      }
    }
  }
}

// fwd_pass over rows zl .. n - 1 of a CD table in straight-line groups of R
// rows while they last, then of R / 2, ..., 1 (R a power of two), each
// group handed to done(zl, acc, std::integral_constant<int, R>).
template <int S, int R, bool X3, bool RING, class Done>
__device__ __forceinline__ void fwd_rows(AbRing& ring, const uint2* w2f, const uint2* w2f_lo, const float* cdv,
                                         int stride, int rstride, int zl, int n, Done& done) {
  for (; n - zl >= R; zl += R) {
    float acc[(R * S + 1) / 2][4];
    fwd_pass<S, R, X3, RING>(ring, w2f, w2f_lo, cdv + zl * rstride, stride, rstride, acc);
    done(zl, acc, std::integral_constant<int, R>{});
  }
  if constexpr (R > 1) fwd_rows<S, R / 2, X3, RING>(ring, w2f, w2f_lo, cdv, stride, rstride, zl, n, done);
}

// The groups of a chunk of n <= ZF rows (ZF a power of two): one of ZF rows
// for a whole chunk, else ZF / 2, ZF / 4, ..., 1 while they last: popc(n)
// passes a tile.
template <int S, int ZF, bool X3, bool RING, class Done>
__device__ __forceinline__ void fwd_chunk(AbRing& ring, const uint2* w2f, const uint2* w2f_lo, const float* cdv,
                                          int stride, int rstride, int n, Done&& done) {
  if (n == ZF) {
    fwd_rows<S, ZF, X3, RING>(ring, w2f, w2f_lo, cdv, stride, rstride, 0, n, done);
  } else if constexpr (ZF > 1) {
    fwd_rows<S, ZF / 2, X3, RING>(ring, w2f, w2f_lo, cdv, stride, rstride, 0, n, done);
  }
}

// This warp's ring for chunk c (K2 and K4 call it before the barrier that
// publishes the chunk's CD rows): its descriptor (its tile row's AB, the
// chunk's tiles and passes), and with RING its first FW_NS - 1 slabs
// issued. ring_s: the block's rings.
template <bool RING>
__device__ __forceinline__ AbRing ring_start(float* ring_s, const float* ab, const mlph::Chunk& c, int nx, int ny,
                                            int H) {
  const int warp = threadIdx.x >> 5, gy = c.y0 + warp;
  AbRing ring;
  ring.st = (unsigned)__cvta_generic_to_shared(ring_s + warp * FW_NS * FW_STAGE) + AbRing::lane_copy();
  if (gy < ny) {  // the warp has a tile row (warp-uniform)
    __syncwarp();  // the last chunk's reads of the descriptor and the stages done
    if ((threadIdx.x & 31) == 0)
      fw_desc[warp] = RingDesc{ab + (size_t)gy * nx + c.x0, nx * ny, nx - c.x0, H, (H + 15) >> 4, __popc(c.n),
                               c.x0 + 16 < nx ? 2 : 1};
    __syncwarp();
    if (RING) ring.start();
  }
  return ring;
}

// The fields of a chunk's rows (K2 and K4's fields pass): warp w takes tile
// row y0 + w as two 16-cell tiles (a lane's cells x0 + 16 m + 2g, + 1),
// streaming AB through its ring (ring_start), and stores its C fragments
// through the channel map: lane t holds outputs 2 (t % 2), + 1 of value 2f
// + t / 2 of fragment f, b2 added, the channel planes from fw_chans (the
// kernel writes it before the chunk loop's first barrier; a Chans indexed
// at run time went through local memory, and its stores lost their global
// space). cd_s is the chunk's table [HP16][ZF + 1][P]: one padding row a
// hidden unit, so that the four lanes of a cell, which read the rows of
// hidden units 2t apart, meet distinct banks (at ZF P floats a unit their
// float4s met the same banks: 4-way conflicts, which cost K2's bf16 tier
// 45% on an H100).
template <int S, int ZF, int P, bool X3, bool RING>
__device__ __forceinline__ void fields_chunk(AbRing& ring, const float* cd_s, const uint2* w2f, const uint2* w2f_lo,
                                             const float* __restrict__ b2, const mlph::Chunk& c, int nx, int ny) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int gy = c.y0 + warp;
  if (gy < ny) {  // warp-uniform
    const int ntile = ring.d().ntile;
#pragma unroll 1
    for (int m = 0; m < ntile; ++m) {
      ring.cm = m;
      fwd_chunk<S, ZF, X3, RING>(ring, w2f, w2f_lo, cd_s, (ZF + 1) * P, P, c.n,
                                 [&](int zl0, const auto& acc, auto rows) {
        constexpr int V = decltype(rows)::value * S;
        const bool odd = t & 1, second = t >> 1;  // this lane's outputs 2 odd, + 1 of value 2f + second
        const float bo0 = __ldg(b2 + 2 * odd), bo1 = __ldg(b2 + 2 * odd + 1);
        const int xl = c.x0 + 16 * m + 2 * g;  // this lane's cells xl, xl + 1
        const bool pair = (nx & 1) == 0 && xl + 1 < nx;  // both inside, 8-byte aligned
        const size_t rowc = (size_t)gy * nx;
        // (the plane read here, after the pass: computed before it, the
        // rows' offsets were held through the k-step loop and spilled)
        const int plane = ring.d().plane;
#pragma unroll
        for (int f = 0; f < (V + 1) / 2; ++f) {
          const int va = 2 * f, vb = 2 * f + 1;
          if (second && vb >= V) continue;
          const int ch = (second ? vb % S : va % S) * 4 + 2 * odd;  // this lane's channel pair
          float* p0 = fw_chans[ch];
          float* p1 = fw_chans[ch + 1];
          const int zl = second ? vb / S : va / S;
          const size_t at = (size_t)(c.z0 + zl0 + zl) * plane + rowc;
          // (st.global: the pointers come through shared memory, so the
          // compiler cannot see that they are global)
          if (pair) {
            __stwb(reinterpret_cast<float2*>(p0 + at + xl), make_float2(acc[f][0] + bo0, acc[f][2] + bo0));
            __stwb(reinterpret_cast<float2*>(p1 + at + xl), make_float2(acc[f][1] + bo1, acc[f][3] + bo1));
          } else if (xl < nx) {
            __stwb(p0 + at + xl, acc[f][0] + bo0);
            __stwb(p1 + at + xl, acc[f][1] + bo1);
            if (xl + 1 < nx) {
              __stwb(p0 + at + xl + 1, acc[f][2] + bo0);
              __stwb(p1 + at + xl + 1, acc[f][3] + bo1);
            }
          }
        }
      });
    }
  }
}

}  // namespace mma16
}  // namespace
