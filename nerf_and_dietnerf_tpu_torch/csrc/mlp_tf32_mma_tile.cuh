// f32 tensor-core device code of the MLP backwards and of the compositing
// forwards: the forward tile and the chain back of mlp_mma_tile.cuh at
// true-f32 accuracy, with 3xTF32 `mma.sync.m16n8k8` products. f32 B2
// (mlp_bwd.cu) and f32 B6's backward (raymarch_bwd.cu, on the inputs it
// builds) run them as backward_tile on strided 64-row tiles; f32 B7's
// backward (raymarch_comp_bwd.cu), f32 B5 (mlp_loss_comp.cu) and f32 B4's
// backward (mlp_comp_bwd.cu) through the ray-group loop of comp_mma_tile.cuh
// (Kit below), and f32 B7's and B4's forwards (raymarch_comp_fwd.cu,
// mlp_comp_fwd.cu) through its forward loop: forward_tile alone, writing the
// raw rows. f32 B1 and B6's forward run mlp_tf32_tile.cuh (`wgmma`).
//
// What bounds it on an H100: operations. A row's backward is about 3 x 1.024
// MFLOP at the flagship widths; true f32 on the tensor cores takes three TF32
// products for each, at the 495 TFLOP/s TF32 peak: 4.88 ms per 262,144 rows.
// Beside that, each 64-row tile reads and writes its block's weight-gradient
// slab once (514,332 f32 entries at the flagship widths: about 4.1 MB a
// tile): about 17 GB over the 4,096 tiles of 262,144 rows, 5 ms at the HBM
// rate, a floor of its own that 128-row tiles would halve but cannot fit
// (below).
//
// What the design does about that.
// - Split: v = hi + lo with hi = rna_tf32(v), lo = rna_tf32(v - hi)
//   (rna: an add and a mask on the bits, as raymarch_cuda.round_tf32), in
//   registers, for the activations, gradient tiles and inputs as for the
//   weights. Each product is lo.hi + hi.lo + hi.hi, small terms first. No raw
//   f32 bits reach the tensor core (it would drop their 13 low bits).
// - Accumulation: each 8-deep k-step's three products go into a fresh zero
//   accumulator, which round-to-nearest f32 adds then add to the layer's sum
//   (the FRESH rule of mlp_mma_tile.cuh's mma_step): the tensor core's own
//   running sum, which truncates, never carries the sum. The narrow products
//   (N <= 3 or K <= 3: the rgb / sigma heads, the output cotangent in their
//   weight gradients, g W^T with K = 3 or 1) stay f32 FMAs, as in bf16.
// - Issue order: a product's three terms form a chain (each adds to the
//   fresh partial of the one before), and an m16n8k8 product's result comes
//   back tens of cycles after its issue. Issued chain by chain, under a
//   branch per n-tile, the compiler gave every chain of a loop the same
//   registers, so each product waited for the one before it; the phase
//   profile (tools/t32_phases.py) found the three product phases taking 46
//   of the 53.5 ms of f32 B7's backward. So each group of partials (4
//   n-tiles x 2 m-tiles in the forward and the chain back, mma_ntiles; 2 x 4
//   in the weight gradients) is issued term by term across the group, whole
//   groups branch-free: eight independent products between a product and
//   the one that adds to its result. Each partial keeps its order of terms
//   and sums, so the results are bitwise those of the chain-by-chain order.
// - Tile: BM = 64 rows a block, 8 warps. A product's output (64 x Np) is cut
//   into 2 row halves x 4 column groups: warp (wm, wn) owns rows 32 wm .. +32
//   and the 8-column n-tiles wn, wn + 4, ..., wn + 28; its accumulators are 2
//   m-tiles x 8 n-tiles x 4 = 64 floats.
// - The weight-gradient products A^T G contract over the tile's rows, so both
//   operands are read M-major; `ldmatrix.trans` has no 32-bit form. The
//   fragments of `mma.sync` are per-thread registers, so A^T's and G's are
//   read by 32-bit shared loads with the indices swapped: lane (g, t) reads
//   A[row t][column g] for A^T as G[row t][column g] for G, with no transposed
//   copy. The activation tiles (P, G, X, D) are f32 with row strides of 8
//   (mod 32) floats, so those four rows x eight columns fall in 32 different
//   banks; and column c of row r is stored at c ^ (r & 4) (sw), so the
//   forward orientation's eight rows x four columns (g, t) fall in 32 banks
//   too. A swizzle moves a column within its aligned group of 8, so the first
//   8k columns of a row are the first 8k stored, whatever k.
// - Weights: the wrapper packs every matrix W (K, N) of the 11 products
//   (matrices 0..10) in f32, F as W^T (pad16(N), pad16(K)), B as W (pad16(K),
//   pad16(N)), both "rows = outputs, columns = contraction", chunk-major:
//   each chunk of KC = 16 contraction columns is its rows x 16 floats in one
//   piece, a row's two 8-column halves swapped on rows with r & 2 and each
//   half's columns in the order 0 4 1 5 2 6 3 7 (t32_col): a lane's two
//   B-fragment columns t and t + 4 are one 8-byte load, and a k-step's eight
//   fragment rows fall in 32 banks. The flat f32 head matrices 11.. follow
//   the pack (raymarch_cuda.t32_packs). A product streams its matrix chunk
//   by chunk through a two-stage ring: one `cp.async.bulk` a chunk, issued
//   by thread 0 into the other stage while the warps multiply this one, its
//   bytes counted by the stage's mbarrier; a barrier a chunk, before the
//   next issue, keeps a stage from being refilled while a warp reads it.
//   Streaming f32 and splitting in registers, rather than streaming hi and
//   lo packs, halves the ring's bytes, its copies and its barriers per
//   product; the split is the wrapper's, so the products are the same.
// - Shared memory (bytes): forward P 67,584 + X 18,432 + D 10,240 + ring
//   32,768 + sigma 256 = 129,280; backward adds G 67,584 and the cotangent
//   2,048: 198,912 of the 232,448 a block may use, which leaves room for the
//   group's rows at S = MAX_S_COMP (comp_mma_tile.cuh: 217,348), and for the
//   ring's two mbarriers, 16 bytes of static shared memory. 128-row f32
//   tiles would need P and G at 135,168 bytes each: 270 KB, over the limit.
// - Kept activations: NACT x 64 x 256 f32 (655,360 bytes) a tile, the same
//   bytes as bf16's 128-row slots.
#pragma once

#include <stdint.h>

#include "mlp_common.cuh"
#include "mlp_mma_tile.cuh"
#include "mlp_tf32_tile.cuh"
#include "t32_phases.cuh"

namespace nerf_tmma {

using nerf_mlp::Dims;
using nerf_mlp::Layout;
using nerf_mlp::N_TRUNK;
using nerf_mlp::SKIP;
using nerf_mlp::trunk_w;
using nerf_mma::bwd_next;
using nerf_mma::cp_async16;
using nerf_mma::cp_async_commit;
using nerf_mma::cp_async_wait_all;

constexpr int BM = 64;           // rows per tile
constexpr int NT = 256;          // threads per block
constexpr int HPAD = 256;        // widest padded layer; rows of a ring stage
constexpr int LDH = HPAD + 8;    // row stride of P and G (floats, = 8 mod 32)
constexpr int LDX = 64 + 8;      // row stride of X (xyz <= 64)
constexpr int LDD = 32 + 8;      // row stride of D (dir <= 32)
constexpr int KC = 16;           // contraction columns of a streamed chunk (two k-steps)
constexpr int LDW = KC;          // row stride of a ring stage
constexpr int STAGE = HPAD * LDW;  // floats of a stage
constexpr int NSTAGE = 2;
constexpr int NACT = 10;         // activation slots of the backward
constexpr int SLOT = BM * HPAD;  // elements of one activation slot
constexpr int N_PROD = 11;       // matrices 0..10 run on the tensor cores

static_assert(LDH % 32 == 8 && LDX % 32 == 8 && LDD % 32 == 8,
              "the transposed fragments' rows must fall in different banks");

__host__ __device__ constexpr int pad8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

// Where column c of tile row r is stored.
__device__ __forceinline__ int sw(int r, int c) { return c ^ (r & 4); }

struct T32Layout {
  int off[N_PROD];  // float offset of matrix i in the pack
  int kp[N_PROD];   // pad16(K)
  int np[N_PROD];   // pad16(N)
  int total;        // floats of the pack
  int heads;        // float offset of the flat head matrices: after the pack
};

inline T32Layout make_t32_layout(const Layout& L) {
  T32Layout T{};
  for (int i = 0; i < N_PROD; ++i) {
    T.kp[i] = pad16(L.wk[i]);
    T.np[i] = pad16(L.wn[i]);
    T.off[i] = T.total;
    T.total += T.kp[i] * T.np[i];
  }
  T.heads = T.total;
  return T;
}

// Head matrix i (11..) of a weight buffer, flat f32 (K, N) row-major.
__device__ __forceinline__ const float* head(const float* W, const T32Layout& M, const Layout& L,
                                             int i) {
  return W + M.heads + (L.w[i] - L.w[11]);
}

// --------------------------------------------------------------------------
// Products

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32, nearest with ties away from zero, low 13 bits zero, as
// raymarch_cuda.round_tf32 rounds it: one add and one mask on the bits, for
// every finite v as cvt.rna.tf32.f32 (which sm_90 runs as an add, a compare,
// a select and the mask).
__device__ __forceinline__ uint32_t rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v as hi + lo, both TF32 (v - hi is exact in f32).
__device__ __forceinline__ void split1(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna(v);
  lo = rna(v - __uint_as_float(hi));
}

// Two floats from a shared-window address: the ring's stages are addressed
// so, which keeps the loads shared (a generic pointer there compiled to
// generic loads).
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split1(v[i], hi[i], lo[i]);
}

// --------------------------------------------------------------------------
// Accumulators. acc[mt][q][e] holds row 32 wm + 16 mt + g + 8 (e >> 1) and
// column 8 (wn + 4 q) + 2 t + (e & 1), with warp = 2 wn + wm, g = lane / 4,
// t = lane % 4 (the C fragment of mma.m16n8k8).
typedef float Acc[2][8][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
}

struct Frag {
  int wm, wn, g, t;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = warp & 1; wn = warp >> 1; g = lane >> 2; t = lane & 3;
  }
  __device__ int row(int mt, int half) const { return 32 * wm + 16 * mt + g + 8 * half; }
  __device__ int ntile(int q) const { return wn + 4 * q; }
  __device__ int col(int q) const { return 8 * ntile(q) + 2 * t; }
};

// A packed matrix as a product reads it: `rows` outputs (<= HPAD) by `cols`
// contraction columns (a multiple of 16), chunk-major: chunk c, columns
// [16 c, 16 c + 16), is rows x 16 contiguous floats (t32_col).
struct Mat {
  const float* w;
  int rows, cols;
};

__device__ __forceinline__ Mat fmat(const float* F, const T32Layout& M, int i) {
  return Mat{F + M.off[i], M.np[i], M.kp[i]};
}
__device__ __forceinline__ Mat bmat(const float* Bp, const T32Layout& M, int i) {
  return Mat{Bp + M.off[i], M.kp[i], M.np[i]};
}

// Where a chunk row stores contraction column c (0..15) of row r: the two
// 8-column halves (the chunk's two k-steps) swapped on rows with r & 2, the
// columns of each half in the order 0 4 1 5 2 6 3 7 (raymarch_cuda.t32_packs
// lays the packs out so). A lane's two B-fragment columns t and t + 4 are
// then one 8-byte load, and the eight rows g of a k-step's fragments fall in
// 32 banks although a row is 64 bytes.
__host__ __device__ constexpr int t32_col(int r, int c) {
  return ((((c >> 3) ^ (r >> 1)) & 1) << 3) + 2 * (c & 3) + ((c >> 2) & 1);
}

// The weight ring: NSTAGE stages of a chunk (HPAD rows x KC columns), each
// filled by one bulk copy (`cp.async.bulk`, issued by thread 0) whose bytes
// its mbarrier counts. `stage` holds the chunk the next product consumes
// first (issued, maybe not yet landed); bit s of `phase` is the parity of
// stage s's next completion.
struct Ring {
  float* buf;
  int stage;
  unsigned phase;
};

// The stages' mbarriers (one arrival, thread 0's, plus the copy's bytes).
__device__ __forceinline__ uint32_t ring_bar(int s) {
  __shared__ unsigned long long bars[NSTAGE];  // 8-byte aligned, as mbarriers must be
  return nerf_tf32::saddr(&bars[s]);
}

__device__ __forceinline__ void issue_chunk(float* dst, uint32_t bar, const Mat& m, int k0) {
  if (threadIdx.x != 0) return;
#if NERF_T32_CUT & T32_CUT_RING
  nerf_tf32::mbar_arrive(bar);
#else
  const uint32_t bytes = 4u * KC * m.rows;
  nerf_tf32::mbar_expect_tx(bar, bytes);
  nerf_tf32::bulk_copy(nerf_tf32::saddr(dst), m.w + (size_t)k0 * m.rows, bytes, bar);
#endif
}

// Once a kernel, by every thread: the stages' mbarriers, then m's first chunk
// into ring.stage. The first product waits behind a barrier, so no thread
// waits on an mbarrier before thread 0 made it.
__device__ __forceinline__ void ring_start(Ring& ring, const Mat& m) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) nerf_tf32::mbar_init(ring_bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  issue_chunk(ring.buf + ring.stage * STAGE, ring_bar(ring.stage), m, 0);
}

// acc[mt][Q0 + q] += one k-step's products for this warp's n-tiles Q0 .. Q0 +
// QN - 1 and both m-tiles, from half `half` (its columns 8 half .. + 8) of
// the stage at shared address `cur`: the B fragments loaded and split
// first, then each of the three terms (lo.hi, hi.lo, hi.hi, small terms
// first) issued across the 2 QN fresh zero partials in turn, so no product
// waits on the one before it; then each partial is added to its accumulator
// with a round-to-nearest f32 add (the FRESH rule of the header comment).
template <int Q0, int QN>
__device__ __forceinline__ void mma_ntiles(Acc& acc, const uint32_t (&ahi)[2][4],
                                           const uint32_t (&alo)[2][4], uint32_t cur,
                                           int half, const Frag& f) {
  uint32_t bh[QN][2], bl[QN][2];
#pragma unroll
  for (int q = 0; q < QN; ++q) {
    const int row = 8 * f.ntile(Q0 + q) + f.g;
    const float2 w = lds2(cur + 4u * (row * LDW + t32_col(row, 8 * half) + 2 * f.t));
    split1(w.x, bh[q][0], bl[q][0]);
    split1(w.y, bh[q][1], bl[q][1]);
  }
  float p[QN][2][4];
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[q][mt][e] = 0.f;
#if !(NERF_T32_CUT & T32_CUT_LO)
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(p[q][mt], alo[mt], bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(p[q][mt], ahi[mt], bl[q][0], bl[q][1]);
#endif
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(p[q][mt], ahi[mt], bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][Q0 + q][e] += p[q][mt][e];
}

// acc += A (64 x m.cols, row stride lda, swizzled) @ m^T, m streamed through
// the ring. Expects m's first chunk issued into ring.stage; issues `next`'s
// first chunk (if any) while it computes its last. Ends with a barrier, so
// the caller may overwrite A afterwards.
__device__ __forceinline__ void mma_rows(Acc& acc, const float* A, int lda, const Mat& m,
                                         const Mat* next, Ring& ring) {
  const Frag f;
  // This warp's n-tiles are wn + 4 q for q < nq (warp-uniform): whole
  // groups of them run branch-free (mma_ntiles).
  const int nq = min(8, (m.rows / 8 - f.wn + 3) / 4);
  T32_PHASE(T32_WAIT_PHASE);
  for (int k0 = 0; k0 < m.cols; k0 += KC) {
    T32_STEP(T32_WAIT_PHASE);
    __syncthreads();  // every warp is done with the other stage
    const int s = ring.stage;
    const uint32_t cur = nerf_tf32::saddr(ring.buf + s * STAGE);
    float* nxt = ring.buf + (s ^ 1) * STAGE;
    if (k0 + KC < m.cols) {
      issue_chunk(nxt, ring_bar(s ^ 1), m, k0 + KC);
    } else if (next) {
      issue_chunk(nxt, ring_bar(s ^ 1), *next, 0);
    }
    nerf_tf32::mbar_wait(ring_bar(s), (ring.phase >> s) & 1);
    ring.phase ^= 1u << s;
    T32_STEP(T32_MMA_PHASE);
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // the chunk's two 8-deep k-steps
      const int k = k0 + 8 * half;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = f.row(mt, 0);  // rows r and r + 8 share r & 4
        const float* a0 = A + r * lda, *a1 = a0 + 8 * lda;
        const float v[4] = {a0[sw(r, k + f.t)], a1[sw(r, k + f.t)], a0[sw(r, k + f.t + 4)],
                            a1[sw(r, k + f.t + 4)]};
        split4(v, ahi[mt], alo[mt]);
      }
      switch (nq) {
        case 8:
          mma_ntiles<0, 4>(acc, ahi, alo, cur, half, f);
          mma_ntiles<4, 4>(acc, ahi, alo, cur, half, f);
          break;
        case 7:
          mma_ntiles<0, 4>(acc, ahi, alo, cur, half, f);
          mma_ntiles<4, 3>(acc, ahi, alo, cur, half, f);
          break;
        case 6:
          mma_ntiles<0, 4>(acc, ahi, alo, cur, half, f);
          mma_ntiles<4, 2>(acc, ahi, alo, cur, half, f);
          break;
        case 5:
          mma_ntiles<0, 4>(acc, ahi, alo, cur, half, f);
          mma_ntiles<4, 1>(acc, ahi, alo, cur, half, f);
          break;
        case 4: mma_ntiles<0, 4>(acc, ahi, alo, cur, half, f); break;
        case 3: mma_ntiles<0, 3>(acc, ahi, alo, cur, half, f); break;
        case 2: mma_ntiles<0, 2>(acc, ahi, alo, cur, half, f); break;
        case 1: mma_ntiles<0, 1>(acc, ahi, alo, cur, half, f); break;
        default: break;
      }
    }
    ring.stage ^= 1;
  }
  __syncthreads();
}

// *p += v (and p[1] += w) in L2, with no value returned: each entry of a
// block's weight-gradient slab has one owner, the same thread of the same
// block from tile to tile, so its adds land in that thread's order and the
// sums are the ones `*p = *p + v` would give, without the read's latency in
// the warp or the old values in registers.
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}
__device__ __forceinline__ void red_add2(float* p, float v, float w) {  // p 8-byte aligned
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(v), "f"(w) : "memory");
}

// dst (K, N) row-major f32 (+)= A^T G over the tile's BM rows: A (BM x Kp,
// stride lda), G (BM x Np, stride ldg), both swizzled f32 in shared memory.
// The (Kp x Np) result is cut into 32 x 32 warp tiles dealt out to the
// warps; each entry of dst is written by one thread. The fragments are read
// transposed: a0 = A[r0 + t][k + g], b0 = G[r0 + t][n + g] (and their + 4 row
// / + 8 column partners). The sums go to the slab as adds in L2 (red_add2:
// two neighbouring columns a request where aligned; the first tile stores).
// Every warp tile computes all its 2 x 4 fragment tiles, branch-free, each
// of the three terms issued across the eight fresh partials in turn (as
// mma_ntiles); the columns of a part-filled tile past Kp or Np read other
// columns of the same rows (every tile's row stride covers them) into sums
// that are not stored.
__device__ __forceinline__ void mma_wgrad(float* __restrict__ dst, const float* A, int lda, int K,
                                          const float* G, int ldg, int N, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Kp = pad8(K), Np = pad8(N);
  const int tiles_n = (Np + 31) / 32, tiles = ((Kp + 31) / 32) * tiles_n;
  // Column pairs (n even) go as one 8-byte add where the slab is 8-byte
  // aligned (B5's slab of an odd block is not: it has one more entry).
  const bool pairs = (N & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
  for (int wt = warp; wt < tiles; wt += NT / 32) {
    const int m0 = (wt / tiles_n) * 32, n0 = (wt % tiles_n) * 32;
    float c[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
    for (int r0 = 0; r0 < BM; r0 += 8) {
      const int ra = r0 + t, rb = ra + 4;  // ra & 4 == 0, rb & 4 == 4
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = m0 + 16 * mt + g;
        const float v[4] = {A[ra * lda + sw(ra, k)], A[ra * lda + sw(ra, k + 8)],
                            A[rb * lda + sw(rb, k)], A[rb * lda + sw(rb, k + 8)]};
        split4(v, ahi[mt], alo[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 8 * nt + g;
        split1(G[ra * ldg + sw(ra, n)], bhi[nt][0], blo[nt][0]);
        split1(G[rb * ldg + sw(rb, n)], bhi[nt][1], blo[nt][1]);
      }
      float p[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.f;
#if !(NERF_T32_CUT & T32_CUT_LO)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(p[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(p[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#endif
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(p[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mt][nt][e] += p[mt][nt][e];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows k, columns n and n + 1
          const int k = m0 + 16 * mt + g + 8 * h, n = n0 + 8 * nt + 2 * t;
          if (k >= K || n >= N) continue;
          float* p = dst + (size_t)k * N + n;
          const float a = c[mt][nt][2 * h], b = c[mt][nt][2 * h + 1];
          if (first || (NERF_T32_CUT & T32_CUT_OLD)) {
            p[0] = a;
            if (n + 1 < N) p[1] = b;
          } else if (pairs) {
            red_add2(p, a, b);
          } else {
            red_add(p, a);
            if (n + 1 < N) red_add(p + 1, b);
          }
        }
  }
}

// dst (K, N) (+)= A^T C for a narrow f32 cotangent C (BM x N, row stride 8,
// N <= 3): one entry per thread; four partial sums (rows r % 4 = 0..3) added
// in a fixed order.
__device__ inline void narrow_wgrad(float* __restrict__ dst, const float* A, int lda, int K,
                                    const float* C, int N, bool first) {
  for (int e = threadIdx.x; e < K * N; e += NT) {
    const int k = e / N, j = e - k * N;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i] = fmaf(A[(r + i) * lda + sw(r + i, k)], C[(r + i) * 8 + j], s[i]);
    const float v = (s[0] + s[1]) + (s[2] + s[3]);
    dst[e] = first ? v : dst[e] + v;
  }
}

// dst (N) (+)= column sums of a gradient tile / an f32 cotangent.
__device__ inline void bgrad(float* __restrict__ dst, const float* G, int ldg, int N, bool first) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += G[(r + i) * ldg + sw(r + i, n)];
    const float v = (s[0] + s[1]) + (s[2] + s[3]);
    dst[n] = first ? v : dst[n] + v;
  }
}
__device__ inline void narrow_bgrad(float* __restrict__ dst, const float* C, int N, bool first) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += C[(r + i) * 8 + n];
    const float v = (s[0] + s[1]) + (s[2] + s[3]);
    dst[n] = first ? v : dst[n] + v;
  }
}

// --------------------------------------------------------------------------
// Tiles

struct Tiles {
  float* P;     // activations (BM x LDH)
  float* G;     // gradients (BM x LDH), backward only
  float* X;     // encoded xyz (BM x LDX)
  float* D;     // encoded view dirs (BM x LDD)
  float* ring;  // NSTAGE x STAGE
  float* sig;   // sigma of each row (BM), forward output
  float* GI;    // output cotangent (BM x 8): grgb | gsig | gsig, backward only
};

constexpr size_t fwd_smem_bytes() {
  return 4 * ((size_t)BM * LDH + BM * LDX + BM * LDD + NSTAGE * STAGE + BM);
}
constexpr size_t bwd_smem_bytes() { return fwd_smem_bytes() + 4 * ((size_t)BM * LDH + BM * 8); }
static_assert(fwd_smem_bytes() == 129280 && bwd_smem_bytes() == 198912,
              "the shared-memory budget of the header comment");

__device__ inline Tiles make_tiles(void* smem, bool backward) {
  Tiles t;
  t.P = static_cast<float*>(smem);
  t.X = t.P + BM * LDH;
  t.D = t.X + BM * LDX;
  t.ring = t.D + BM * LDD;
  t.G = t.ring + NSTAGE * STAGE;
  t.sig = backward ? t.G + BM * LDH : t.G;
  t.GI = t.sig + BM;
  if (!backward) t.G = nullptr;
  return t;
}

// Rows [row0, row0 + BM) of a global (n, width) f32 array into a tile of row
// stride ld, stored swizzled (sw): columns [width, pad16(width)) and rows at
// or past n are zero (the weight-gradient products read up to pad16 columns;
// the zeros keep whatever the tile held before out of every sum).
__device__ inline void load_rows(float* T, int ld, const float* __restrict__ src, int width,
                                 int row0, int n) {
  const int wp = nerf_mma::pad16(width);
  for (int i = threadIdx.x; i < BM * wp; i += NT) {
    const int r = i / wp, c = i - r * wp, row = row0 + r;
    T[r * ld + sw(r, c)] = row < n && c < width ? src[(size_t)row * width + c] : 0.f;
  }
}

// GI from the (n, 4) f32 cotangent; rows past n are zero.
__device__ inline void load_cotangent(float* GI, const float* __restrict__ g, int row0, int n) {
  for (int i = threadIdx.x; i < BM * 4; i += NT) {
    const int r = i >> 2, c = i & 3;
    const float v = row0 + r < n ? g[(size_t)(row0 + r) * 4 + c] : 0.f;
    GI[r * 8 + c] = v;
    if (c == 3) GI[r * 8 + 4] = v;
  }
}

// The first `width` (a multiple of 8) columns of P to / from an activation
// slot (BM x HPAD) in global memory, 16 bytes a copy, as stored (swizzled).
__device__ inline void store_slot(float* __restrict__ slot, const float* P, int width) {
  const int vecs = width / 4;
  for (int i = threadIdx.x; i < BM * vecs; i += NT) {
    const int r = i / vecs, v = i - r * vecs;
    *reinterpret_cast<float4*>(slot + r * HPAD + v * 4) =
        *reinterpret_cast<const float4*>(P + r * LDH + v * 4);
  }
}
// Ends with every copy landed and a barrier.
__device__ inline void load_slot(float* P, const float* __restrict__ slot, int width) {
  const int vecs = width / 4;
  for (int i = threadIdx.x; i < BM * vecs; i += NT) {
    const int r = i / vecs, v = i - r * vecs;
    cp_async16(P + r * LDH + v * 4, slot + r * HPAD + v * 4);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// P = leaky(acc + bias) in f32 over the product's np (padded) columns; the
// pad columns get bias 0 and hold 0.
__device__ __forceinline__ void store_leaky(const Acc& acc, const float* __restrict__ bias, int N,
                                            int np, float alpha, float* P) {
  const Frag f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = f.col(q);
    if (n >= np) continue;
    const float b0 = n < N ? bias[n] : 0.f, b1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(mt, half);
        float v0 = acc[mt][q][2 * half] + b0, v1 = acc[mt][q][2 * half + 1] + b1;
        v0 = v0 >= 0.f ? v0 : alpha * v0;
        v1 = v1 >= 0.f ? v1 : alpha * v1;
        *reinterpret_cast<float2*>(P + r * LDH + sw(r, n)) = make_float2(v0, v1);
      }
  }
}

// G = leaky'(post) * acc for the np columns (0 past N), in f32 (the head's
// chain and the trunk's are the same without roundings).
__device__ __forceinline__ void grad_tile(const Acc& acc, const float* post, int N, int np,
                                          float alpha, float* G) {
  const Frag f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = f.col(q);
    if (n >= np) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(mt, half);
        const float2 p = *reinterpret_cast<const float2*>(post + r * LDH + sw(r, n));
        float v0 = acc[mt][q][2 * half], v1 = acc[mt][q][2 * half + 1];
        v0 = p.x >= 0.f ? v0 : alpha * v0;
        v1 = p.y >= 0.f ? v1 : alpha * v1;
        if (n >= N) v0 = 0.f;
        if (n + 1 >= N) v1 = 0.f;
        *reinterpret_cast<float2*>(G + r * LDH + sw(r, n)) = make_float2(v0, v1);
      }
  }
}

// acc += c[r] w[n] for n < N: a K = 1 product (c = GI column 4, w a flat f32
// head column).
__device__ __forceinline__ void add_rank1(Acc& acc, const float* GI, const float* __restrict__ w,
                                          int N) {
  const Frag f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = f.col(q) + e;
      if (n >= N) continue;
      const float wn = w[n];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          acc[mt][q][2 * half + e] =
              fmaf(GI[f.row(mt, half) * 8 + 4], wn, acc[mt][q][2 * half + e]);
    }
}

// Global (n, N) f32 rows [row0, row0 + BM) = acc (+ their old value, if add);
// rows past n and columns past N are not written.
__device__ __forceinline__ void store_rows(const Acc& acc, float* __restrict__ dst, int N,
                                          int row0, int n_rows, bool add) {
  const Frag f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + f.row(mt, half);
      if (r >= n_rows) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = f.col(q) + e;
          if (c < N) {
            float* p = dst + (size_t)r * N + c;
            const float v = acc[mt][q][2 * half + e];
            *p = add ? v + *p : v;
          }
        }
    }
}

// --------------------------------------------------------------------------
// Forward tile

// The whole network on one row tile whose X and D are built (and a barrier
// passed) and whose first chunk (F pack, matrix 0) is issued into the ring,
// as nerf_mma::forward_tile: with `keep`, post-activations go to its NACT
// slots; with `out`, the (n, 4) raw rows are written. The narrow heads are f32
// FMAs, four threads a row, each over every fourth column.
__device__ __forceinline__ void forward_tile(const Dims& dm, const Layout& L,
                                             const T32Layout& M, const float* __restrict__ F,
                                             const float* __restrict__ B, const Tiles& t,
                                             Ring& ring, float* keep, float* out, int row0,
                                             const Mat* after) {
  const float alpha = dm.alpha;
  T32_MODE(0);
  Acc acc;
  for (int l = 0; l < N_TRUNK; ++l) {
    const int i = trunk_w(l);
    zero_acc(acc);
    if (l == SKIP) {
      const Mat nx = fmat(F, M, SKIP + 1);
      mma_rows(acc, t.X, LDX, fmat(F, M, SKIP), &nx, ring);
    }
    const Mat nx = fmat(F, M, i + 1);
    mma_rows(acc, l == 0 ? t.X : t.P, l == 0 ? LDX : LDH, fmat(F, M, i), &nx, ring);
    T32_PHASE(nerf_t32ph::FWD_EPI);
    store_leaky(acc, B + L.b[l], dm.hid, M.np[i], alpha, t.P);
    __syncthreads();
    if (keep) store_slot(keep + l * SLOT, t.P, M.np[i]);
  }
  const int tid = threadIdx.x, r = tid >> 2, qd = tid & 3;
  if (out) {  // sigma from h8, before the rgb branch overwrites it
    const float* wh = head(F, M, L, 12);
    float sh = 0.f, sd = 0.f;
    for (int k = qd; k < dm.hid; k += 4) sh = fmaf(t.P[r * LDH + sw(r, k)], wh[k], sh);
    if (dm.has_dir) {
      const float* wd = head(F, M, L, 13);
      for (int k = qd; k < dm.dir; k += 4) sd = fmaf(t.D[r * LDD + sw(r, k)], wd[k], sd);
    }
    sh += __shfl_xor_sync(0xffffffffu, sh, 1);
    sh += __shfl_xor_sync(0xffffffffu, sh, 2);
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    sd += __shfl_xor_sync(0xffffffffu, sd, 2);
    if (qd == 0) t.sig[r] = dm.has_dir ? (sh + sd) + B[L.b[10]] : sh + B[L.b[11]];
  }
  zero_acc(acc);
  if (dm.has_dir) {
    const Mat nx = fmat(F, M, 10);
    mma_rows(acc, t.P, LDH, fmat(F, M, 9), &nx, ring);
    mma_rows(acc, t.D, LDD, fmat(F, M, 10), after, ring);
    T32_PHASE(nerf_t32ph::FWD_EPI);
    store_leaky(acc, B + L.b[8], dm.last, M.np[9], alpha, t.P);
    __syncthreads();
    if (keep) store_slot(keep + 8 * SLOT, t.P, M.np[9]);
  } else {
    const Mat nx = fmat(F, M, 10);
    mma_rows(acc, t.P, LDH, fmat(F, M, 9), &nx, ring);
    T32_PHASE(nerf_t32ph::FWD_EPI);
    store_leaky(acc, B + L.b[8], dm.hid, M.np[9], alpha, t.P);
    __syncthreads();
    if (keep) store_slot(keep + 8 * SLOT, t.P, M.np[9]);
    zero_acc(acc);
    mma_rows(acc, t.P, LDH, fmat(F, M, 10), after, ring);
    T32_PHASE(nerf_t32ph::FWD_EPI);
    store_leaky(acc, B + L.b[9], dm.last, M.np[10], alpha, t.P);
    __syncthreads();
    if (keep) store_slot(keep + 9 * SLOT, t.P, M.np[10]);
  }
  if (out) {  // rgb = rgb_h @ Wro + bro
    const float* wo = head(F, M, L, 11);
    float s[3] = {0.f, 0.f, 0.f};
    for (int k = qd; k < dm.last; k += 4) {
      const float a = t.P[r * LDH + sw(r, k)];
#pragma unroll
      for (int j = 0; j < 3; ++j) s[j] = fmaf(a, wo[k * 3 + j], s[j]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
    }
    if (qd == 0 && row0 + r < dm.n) {
      const float* bo = B + L.b[dm.has_dir ? 9 : 10];
      float* o = out + (size_t)(row0 + r) * 4;
      o[0] = s[0] + bo[0];
      o[1] = s[1] + bo[1];
      o[2] = s[2] + bo[2];
      o[3] = t.sig[r];
    }
  }
}

// --------------------------------------------------------------------------
// Backward tile

// The chain back over one tile, as nerf_mma::backward_walk (the same order of
// products and of the ring's matrices), in f32: with X, D and GI loaded, P
// holding the rgb branch's last post-activation, a barrier passed and the B
// pack's matrix 10 (`b10`) issued into the ring. Weight and bias gradients go
// to the block's slab `part`; dx and dd rows to global memory (dd where
// given).
__device__ __forceinline__ void backward_walk(const Dims& dm, const Layout& L,
                                              const T32Layout& M, const float* __restrict__ Bp,
                                              const Tiles& t, Ring& ring, const float* acts,
                                              float* part, bool first, int row0, float* dx,
                                              float* dd, const Mat* after, const Mat& b10) {
  const float alpha = dm.alpha;
  const int HP = pad16(dm.hid), LP = pad16(dm.last);
  float* pb = part + L.total_w;
  T32_MODE(1);
  T32_PHASE(nerf_t32ph::NARROW);

  // rgb_out (last, 3): its weight and bias gradients, then g_rgb_h =
  // leaky'(rgb_h) (grgb @ Wro^T) with K = 3 in f32.
  narrow_wgrad(part + L.w[11], t.P, LDH, dm.last, t.GI, 3, first);
  narrow_bgrad(pb + L.b[dm.has_dir ? 9 : 10], t.GI, 3, first);
  {
    const float* wo = head(Bp, M, L, 11);
    for (int i = threadIdx.x; i < BM * LP; i += NT) {
      const int r = i / LP, n = i - r * LP;
      float v = 0.f;
      if (n < dm.last) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) s = fmaf(t.GI[r * 8 + j], wo[n * 3 + j], s);
        v = t.P[r * LDH + sw(r, n)] >= 0.f ? s : alpha * s;
      }
      t.G[r * LDH + sw(r, n)] = v;
    }
  }
  __syncthreads();

  Acc acc;
  if (dm.has_dir) {
    T32_PHASE(nerf_t32ph::SLOT);
    load_slot(t.P, acts + 7 * SLOT, HP);  // h8
    T32_PHASE(nerf_t32ph::WGRAD);
    mma_wgrad(part + L.w[9], t.P, LDH, dm.hid, t.G, LDH, dm.last, first);
    mma_wgrad(part + L.w[10], t.D, LDD, dm.dir, t.G, LDH, dm.last, first);
    T32_PHASE(nerf_t32ph::NARROW);
    bgrad(pb + L.b[8], t.G, LDH, dm.last, first);
    narrow_wgrad(part + L.w[12], t.P, LDH, dm.hid, t.GI + 3, 1, first);
    narrow_wgrad(part + L.w[13], t.D, LDD, dm.dir, t.GI + 3, 1, first);
    narrow_bgrad(pb + L.b[10], t.GI + 3, 1, first);
    // dd = g_rgb_h @ Wrh_d^T + gsig @ Wsig_d^T
    const Mat b9 = bmat(Bp, M, 9), b8 = bmat(Bp, M, 8);
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b10, &b9, ring);
    T32_PHASE(nerf_t32ph::GRAD);
    add_rank1(acc, t.GI, head(Bp, M, L, 13), dm.dir);
    if (dd) store_rows(acc, dd, dm.dir, row0, dm.n, false);
    // g_h8 = g_rgb_h @ Wrh_h^T + gsig @ Wsig_h^T
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b9, &b8, ring);
    T32_PHASE(nerf_t32ph::NARROW);
    add_rank1(acc, t.GI, head(Bp, M, L, 12), dm.hid);
  } else {
    T32_PHASE(nerf_t32ph::SLOT);
    load_slot(t.P, acts + 8 * SLOT, HP);  // r0
    T32_PHASE(nerf_t32ph::WGRAD);
    mma_wgrad(part + L.w[10], t.P, LDH, dm.hid, t.G, LDH, dm.last, first);
    T32_PHASE(nerf_t32ph::NARROW);
    bgrad(pb + L.b[9], t.G, LDH, dm.last, first);
    const Mat b9 = bmat(Bp, M, 9), b8 = bmat(Bp, M, 8);
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b10, &b9, ring);
    T32_PHASE(nerf_t32ph::GRAD);
    grad_tile(acc, t.P, dm.hid, HP, alpha, t.G);  // g_r0
    __syncthreads();
    T32_PHASE(nerf_t32ph::SLOT);
    load_slot(t.P, acts + 7 * SLOT, HP);  // h8
    T32_PHASE(nerf_t32ph::WGRAD);
    mma_wgrad(part + L.w[9], t.P, LDH, dm.hid, t.G, LDH, dm.hid, first);
    T32_PHASE(nerf_t32ph::NARROW);
    bgrad(pb + L.b[8], t.G, LDH, dm.hid, first);
    narrow_wgrad(part + L.w[12], t.P, LDH, dm.hid, t.GI + 3, 1, first);
    narrow_bgrad(pb + L.b[11], t.GI + 3, 1, first);
    // g_h8 = g_r0 @ Wrh0^T + gsig @ Wsig^T
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b9, &b8, ring);
    T32_PHASE(nerf_t32ph::NARROW);
    add_rank1(acc, t.GI, head(Bp, M, L, 12), dm.hid);
  }

  // Trunk, reversed; acc holds the gradient of layer l's output and P its
  // post-activation.
  for (int l = N_TRUNK - 1; l >= 0; --l) {
    T32_PHASE(nerf_t32ph::GRAD);
    grad_tile(acc, t.P, dm.hid, HP, alpha, t.G);
    __syncthreads();
    T32_PHASE(nerf_t32ph::SLOT);
    if (l > 0) load_slot(t.P, acts + (l - 1) * SLOT, HP);
    T32_PHASE(nerf_t32ph::NARROW);
    bgrad(pb + L.b[l], t.G, LDH, dm.hid, first);
    T32_PHASE(nerf_t32ph::WGRAD);
    const int i = trunk_w(l);
    if (l == SKIP) {
      mma_wgrad(part + L.w[SKIP], t.X, LDX, dm.xyz, t.G, LDH, dm.hid, first);
      mma_wgrad(part + L.w[SKIP + 1], t.P, LDH, dm.hid, t.G, LDH, dm.hid, first);
      // The skip layer's share of dx goes to dx now; layer 0 adds its own.
      const Mat b5 = bmat(Bp, M, SKIP + 1), b3 = bmat(Bp, M, SKIP - 1);
      zero_acc(acc);
      mma_rows(acc, t.G, LDH, bmat(Bp, M, SKIP), &b5, ring);
      T32_PHASE(nerf_t32ph::GRAD);
      store_rows(acc, dx, dm.xyz, row0, dm.n, false);
      zero_acc(acc);
      mma_rows(acc, t.G, LDH, b5, &b3, ring);
    } else if (l > 0) {
      mma_wgrad(part + L.w[i], t.P, LDH, dm.hid, t.G, LDH, dm.hid, first);
      const Mat nx = bmat(Bp, M, bwd_next(i));
      zero_acc(acc);
      mma_rows(acc, t.G, LDH, bmat(Bp, M, i), &nx, ring);
    } else {
      mma_wgrad(part + L.w[0], t.X, LDX, dm.xyz, t.G, LDH, dm.hid, first);
      zero_acc(acc);
      mma_rows(acc, t.G, LDH, bmat(Bp, M, 0), after, ring);
      T32_PHASE(nerf_t32ph::GRAD);
      store_rows(acc, dx, dm.xyz, row0, dm.n, true);
    }
  }
}

// The backward of one tile whose X, D and GI are loaded (and a barrier
// passed) and whose first forward chunk (F pack, matrix 0) is issued, as
// nerf_mma::backward_tile: the forward into `acts` (the block's NACT slots),
// then backward_walk. B2's f32 kernel (mlp_bwd.cu).
__device__ inline void backward_tile(const Dims& dm, const Layout& L, const T32Layout& M,
                                     const float* __restrict__ F, const float* __restrict__ Bp,
                                     const float* __restrict__ B, const Tiles& t, Ring& ring,
                                     float* acts, float* part, bool first, int row0, float* dx,
                                     float* dd, const Mat* after) {
  const Mat b10 = bmat(Bp, M, 10);
  forward_tile(dm, L, M, F, B, t, ring, acts, nullptr, row0, &b10);
  backward_walk(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, after, b10);
}

// The tile code of the ray-group loops (comp_mma_tile.cuh) on these tiles.
struct Kit {
  using E = float;  // element of the tiles and of the kept slots
  using Pack = T32Layout;
  using Tiles = nerf_tmma::Tiles;
  using Ring = nerf_tmma::Ring;
  using Mat = nerf_tmma::Mat;
  static constexpr int BM = nerf_tmma::BM;
  static constexpr int LDX = nerf_tmma::LDX;
  static constexpr long long TILE_SLOTS = (long long)NACT * SLOT;
  static constexpr size_t fwd_smem_bytes() { return nerf_tmma::fwd_smem_bytes(); }
  static constexpr size_t bwd_smem_bytes() { return nerf_tmma::bwd_smem_bytes(); }
  static __host__ __device__ constexpr int pad(int v) { return pad16(v); }
  static __device__ Tiles tiles(void* smem, bool backward) { return make_tiles(smem, backward); }
  static __device__ Mat fmat(const E* F, const Pack& M, int i) { return nerf_tmma::fmat(F, M, i); }
  static __device__ Mat bmat(const E* Bp, const Pack& M, int i) {
    return nerf_tmma::bmat(Bp, M, i);
  }
  static __device__ void ring_start(Ring& r, const Mat& m) { nerf_tmma::ring_start(r, m); }
  static __device__ void load_slot(E* P, const E* slot, int width) {
    nerf_tmma::load_slot(P, slot, width);
  }
  static __device__ void load_cotangent(float* GI, const float* g, int row0, int n) {
    nerf_tmma::load_cotangent(GI, g, row0, n);
  }
  static __device__ void forward_tile(const Dims& dm, const Layout& L, const Pack& M, const E* F,
                                      const float* B, const Tiles& t, Ring& ring, E* keep,
                                      float* out, int row0, const Mat* after) {
    nerf_tmma::forward_tile(dm, L, M, F, B, t, ring, keep, out, row0, after);
  }
  static __device__ void backward_walk(const Dims& dm, const Layout& L, const Pack& M,
                                       const E* Bp, const Tiles& t, Ring& ring, const E* acts,
                                       float* part, bool first, int row0, float* dx, float* dd,
                                       const Mat* after, const Mat& b10) {
    nerf_tmma::backward_walk(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, after, b10);
  }
};

}  // namespace nerf_tmma

// Floats of each pack (hi, lo) of the f32 tensor-core backward (the wrapper
// checks its packs against it).
extern "C" long long nerf_mlp_t32_pack_elems(int has_dir, int xyz, int dir, int hid, int last) {
  const nerf_mlp::Dims dm{0, xyz, dir, hid, last, has_dir, 0.f};
  return nerf_tmma::make_t32_layout(nerf_mlp::make_layout(dm)).total;
}
