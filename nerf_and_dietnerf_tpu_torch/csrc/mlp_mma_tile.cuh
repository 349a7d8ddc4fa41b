// bf16 tensor-core device code of the radiance-MLP kernels B1 (mlp_fwd.cu)
// and B2 (mlp_bwd.cu), which the ray-march kernels B6 (raymarch_fwd.cu,
// raymarch_bwd.cu) run on the inputs they build and the compositing kernels
// B7 (raymarch_comp_fwd.cu, raymarch_comp_bwd.cu), B5 (mlp_loss_comp.cu) and
// B4 (mlp_comp_fwd.cu, mlp_comp_bwd.cu) run through the ray-group loops of
// comp_mma_tile.cuh: the forward tile (B1, and B2's recompute), the
// input-gradient chain G W^T and the weight-gradient products A^T G. The
// probes P2 (probe_mlp_epilogue.cu: another epilogue policy) and P3
// (probe_mlp_chains.cu: 64 or 128 rows a block) run B1's forward tile too.
// f32 B1 and B6 forward run mlp_tf32_tile.cuh (`wgmma`); every other f32
// kernel (the backwards of B2, B4, B5, B6 and B7, the forwards of B4 and B7)
// runs the 3xTF32 `mma.sync` tiles of mlp_tf32_mma_tile.cuh. mlp_common.cuh
// is included for the flat parameter layout (Dims, Layout) alone.
//
// Products: `mma.sync.m16n8k16` bf16 x bf16 -> f32, as the P1 probe measured
// on the H100 (probe_mma.cu), with operands fed by `ldmatrix`. Chosen over
// `wgmma` as the lower-risk first step: it needs no warpgroup descriptors or
// swizzled layouts, and at a third of the tensor-core peak it already runs
// the MLP's forward (268 GFLOP per 262,144 rows) well under the cuBLAS addmm
// chain's time. `wgmma` (B read once per 64 rows) is the step above that.
// The roundings are those of the FMA tiles: every operand of a wide product
// is a bf16 value, a bf16 x bf16 product is exact in f32 and the sums stay
// f32. The sums differ in order: the tensor core sums each 16-deep step into
// a fresh partial (its own accumulation, not a chain of IEEE f32 adds), and
// round-to-nearest f32 adds sum the partials (mma_step). chip_smoke.py holds
// the kernels and the plain version against an f64 evaluation of the chain
// (F64_FACTOR_BF16).
//
// Tile: BM = 128 rows a block, 8 warps. A product's output (128 x Np) is cut
// into 2 row halves x 4 column groups: warp (wm, wn) owns rows 64 wm .. +64
// and the 16-column pairs wn, wn + 4, wn + 8, wn + 12, so its accumulators
// are 4 m-tiles x 4 pairs x 2 n-tiles x 4 = 128 floats. Per 16-deep step a
// warp issues 4 A and up to 4 B `ldmatrix.x4` for 32 mma: 128 bytes of shared
// memory per mma, half of P1's register-resident form. The forward's
// functions take the number of row halves WM as a template parameter: every
// kernel runs WM = 2 (BM rows, NT threads), the default; the chains probe
// also runs WM = 1 (64 rows, 4 warps).
//
// Operands in shared memory, bf16, rows padded by 8 elements (16 bytes) so
// that the eight row addresses of an `ldmatrix` phase fall in eight different
// 16-byte bank groups: activations P and gradients G (128 x 264), the encoded
// X (128 x 72) and D (128 x 40). Rows past n are zero in X, D and the
// cotangent, so they carry leaky(bias) activations but zero gradients and add
// nothing to any weight gradient; their outputs are not written.
//
// Weights: the wrapper packs every matrix W (K, N) once per call, zero-padded
// to multiples of 16, in two layouts (see make_mma_layout):
//   F pack: W^T as (pad16(N), pad16(K)) row-major, the B operand of x @ W;
//   B pack: W   as (pad16(K), pad16(N)) row-major, the B operand of g @ W^T.
// Both are "rows = outputs, columns = contraction", so one product routine
// serves the forward and the chain back. A product streams its matrix in
// chunks of KC = 32 contraction columns through a two-stage ring with
// `cp.async`: the copy of the next chunk (or of the next product's first)
// overlaps the mma of the current one; nothing is converted while staging.
// The skip layer's two products (x W4a + h W4b) accumulate into one set of
// fragments; the pads of W4a's rows and X's columns are both zero.
//
// Shared memory (bytes): forward P 67,584 + X 18,432 + D 10,240 + ring 40,960
// + sigma 512 = 137,728; backward adds G 67,584 and the cotangent 4,096:
// 209,408 of the 232,448 a block may use.
//
// Backward (B2): the tile's forward is recomputed with its ten post-
// activations copied to the block's scratch slab (10 x 128 x 256 bf16 =
// 640 KB; they do not fit beside G), then read back one at a time
// (`backward_tile` = `forward_tile` + `backward_walk`; the compositing
// backwards of comp_mma_tile.cuh run the two apart, one forward per row). Weight
// gradients: each 128-row tile's A^T G (`ldmatrix.trans` of the row-major
// tiles, 64 x 32 warp tiles) is added to the block's f32 slab by the one
// thread that owns each entry; a second launch adds the slabs in block order
// (grad_slabs.cuh reduce_partials), so the result is bitwise reproducible
// with no atomics.
// Narrow products (N <= 3 or K <= 3: the rgb/sigma heads, the f32 output
// cotangent in their weight gradients, g @ W^T with K = 3 or 1) stay f32 FMAs.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "branch_sink.cuh"
#include "mlp_common.cuh"

namespace nerf_mma {

using bf16 = __nv_bfloat16;
using nerf_mlp::Dims;
using nerf_mlp::Layout;
using nerf_mlp::N_TRUNK;
using nerf_mlp::SKIP;
using nerf_mlp::trunk_w;

constexpr int BM = 128;          // rows per tile
constexpr int NT = 256;          // threads per block
constexpr int HPAD = 256;        // widest padded layer; rows of a ring stage
constexpr int LDH = HPAD + 8;    // row stride of P and G (528 bytes)
constexpr int LDX = 64 + 8;      // row stride of X (xyz <= 64)
constexpr int LDD = 32 + 8;      // row stride of D (dir <= 32)
constexpr int KC = 32;           // contraction columns of a streamed chunk
constexpr int LDW = KC + 8;      // row stride of a ring stage (80 bytes)
constexpr int NSTAGE = 2;
constexpr int NACT = 10;         // activation slots of the backward
constexpr int SLOT = BM * HPAD;  // elements of one activation slot

// Rows and threads of a tile of WM row halves.
template <int WM> constexpr int BM_OF = 64 * WM;
template <int WM> constexpr int NT_OF = 128 * WM;
static_assert(BM_OF<2> == BM && NT_OF<2> == NT, "the kernels' tile is two row halves");

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

struct MmaLayout {
  int off[14];  // element offset of matrix i in either pack
  int kp[14];   // pad16(K)
  int np[14];   // pad16(N)
  int total;    // elements of each pack
};

inline MmaLayout make_mma_layout(const Layout& L) {
  MmaLayout M{};
  for (int i = 0; i < L.nw; ++i) {
    M.kp[i] = pad16(L.wk[i]);
    M.np[i] = pad16(L.wn[i]);
    M.off[i] = M.total;
    M.total += M.kp[i] * M.np[i];
  }
  return M;
}

// Order in which the chain back consumes the B pack: the rgb branch's two
// matrices (view: Wrh_d for dd, Wrh_h; xyz-only: Wrh, Wrh0), then the trunk
// from the top, the skip layer's W4a (its share of dx) before W4b.
__host__ __device__ inline int bwd_next(int i) {
  switch (i) {
    case 10: return 9;
    case 9: return 8;
    case 6: return 4;
    case 4: return 5;
    case 5: return 3;
    case 0: return -1;
    default: return i - 1;
  }
}

// --------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, one m16n8k16 step: the tensor core sums the step's 16 products
// into a fresh zero partial, which round-to-nearest f32 adds then add to c
// (the per-chunk partials of mlp_tf32_tile.cuh, for mma.sync). The tensor
// core's own running sum, which truncates, never carries c. Every product of
// the tile sums this way, so a backward's recomputed forward takes the
// forward kernel's leaky branches.
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// --------------------------------------------------------------------------
// Accumulators. acc[mt][q][h][e] holds row 64 wm + 16 mt + g + 8 (e >> 1) and
// column 16 (wn + 4 q) + 8 h + 2 t + (e & 1), with warp = 2 wn + wm,
// g = lane / 4, t = lane % 4 (the C fragment of mma.m16n8k16).
typedef float Acc[4][4][2][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][h][e] = 0.f;
}

// Row and column of acc[mt][q][h][2 half] (its partner e = 2 half + 1 is the
// next column), in a tile of WM row halves: warp = WM wn + wm.
template <int WM>
struct FragOf {
  static_assert(WM == 1 || WM == 2, "a tile has one or two row halves");
  int wm, wn, g, t;
  __device__ FragOf() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = warp & (WM - 1); wn = warp >> (WM / 2); g = lane >> 2; t = lane & 3;
  }
  __device__ int row(int mt, int half) const { return 64 * wm + 16 * mt + g + 8 * half; }
  __device__ int pair(int q) const { return wn + 4 * q; }
  __device__ int col(int q, int h) const { return 16 * pair(q) + 8 * h + 2 * t; }
};
using Frag = FragOf<2>;

// A packed matrix as a product reads it: `rows` outputs (<= HPAD) by `cols`
// contraction columns (a multiple of 16), row-major.
struct Mat {
  const bf16* p;
  int rows, cols;
};

__device__ __forceinline__ Mat fmat(const bf16* F, const MmaLayout& M, int i) {
  return Mat{F + M.off[i], M.np[i], M.kp[i]};
}
__device__ __forceinline__ Mat bmat(const bf16* Bp, const MmaLayout& M, int i) {
  return Mat{Bp + M.off[i], M.kp[i], M.np[i]};
}

// The weight ring: NSTAGE stages of HPAD rows x KC columns. `stage` holds
// the chunk the next product consumes first (issued, maybe not yet landed).
struct Ring {
  bf16* buf;
  int stage;
};

template <int WM = 2>
__device__ __forceinline__ void issue_chunk(bf16* dst, const Mat& m, int k0) {
  const int vecs = min(KC, m.cols - k0) / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < m.rows * vecs; i += NT_OF<WM>) {
    const int r = i / vecs, v = i - r * vecs;
    cp_async16(dst + r * LDW + v * 8, m.p + (size_t)r * m.cols + k0 + v * 8);
  }
  cp_async_commit();
}

template <int WM = 2>
__device__ __forceinline__ void ring_start(Ring& ring, const Mat& m) {
  issue_chunk<WM>(ring.buf + ring.stage * HPAD * LDW, m, 0);
}

// acc += A (BM_OF<WM> x m.cols, row stride lda) @ m^T, m streamed through
// the ring. Expects m's first chunk issued into ring.stage; issues `next`'s
// first chunk (if any) while it computes its last. Ends with a barrier, so
// the caller may overwrite A afterwards.
template <int WM = 2>
__device__ __forceinline__ void mma_rows(Acc& acc, const bf16* A, int lda, const Mat& m,
                                         const Mat* next, Ring& ring) {
  const int lane = threadIdx.x & 31;
  const FragOf<WM> f;
  const int n_pairs = m.rows / 16;
  const bf16* a_base = A + (64 * f.wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * LDW + 8 * ((lane >> 3) & 1);
  for (int k0 = 0; k0 < m.cols; k0 += KC) {
    cp_async_wait_all();
    __syncthreads();
    const bf16* cur = ring.buf + ring.stage * HPAD * LDW;
    bf16* nxt = ring.buf + (ring.stage ^ 1) * HPAD * LDW;
    if (k0 + KC < m.cols) {
      issue_chunk<WM>(nxt, m, k0 + KC);
    } else if (next) {
      issue_chunk<WM>(nxt, *next, 0);
    }
    const int kc = min(KC, m.cols - k0);
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldsm_x4(a[mt], a_base + 16 * mt * lda + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (f.pair(q) < n_pairs) {
          uint32_t b[4];
          ldsm_x4(b, cur + 16 * f.pair(q) * LDW + b_off + kk);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_step(acc[mt][q][0], a[mt], b[0], b[1]);
            mma_step(acc[mt][q][1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    ring.stage ^= 1;
  }
  __syncthreads();
}

// dst (K, N) row-major f32 (+)= A^T G over the tile's BM rows: A (BM x Kp,
// stride lda), G (BM x Np, stride ldg), both bf16 in shared memory. The
// (Kp x Np) result is cut into 64 x 32 warp tiles dealt out to the warps;
// each entry of dst is written by one thread. The slab's old values are
// loaded before the products, so their latency hides behind the mma.
__device__ inline void mma_wgrad(float* __restrict__ dst, const bf16* A, int lda, int K, const bf16* G,
                                 int ldg, int N, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Kp = pad16(K), Np = pad16(N);
  const int tiles_n = (Np + 31) / 32, tiles = ((Kp + 63) / 64) * tiles_n;
  // ldmatrix.trans row (a contraction row) and column offsets of the lane.
  const int a_r = (lane & 7) + 8 * (lane >> 4), a_c = 8 * ((lane >> 3) & 1);
  const int b_r = (lane & 7) + 8 * ((lane >> 3) & 1), b_c = 8 * (lane >> 4);
  for (int wt = warp; wt < tiles; wt += NT / 32) {
    const int m0 = (wt / tiles_n) * 64, n0 = (wt % tiles_n) * 32;
    float c[4][4][4], old[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = m0 + 16 * mt + g + 8 * (e >> 1), n = n0 + 8 * nt + 2 * t + (e & 1);
          c[mt][nt][e] = 0.f;
          old[mt][nt][e] = !first && k < K && n < N ? dst[(size_t)k * N + n] : 0.f;
        }
    for (int r0 = 0; r0 < BM; r0 += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (m0 + 16 * mt < Kp) ldsm_x4_t(a[mt], A + (r0 + a_r) * lda + m0 + 16 * mt + a_c);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (n0 + 16 * p < Np) {
          uint32_t b[4];
          ldsm_x4_t(b, G + (r0 + b_r) * ldg + n0 + 16 * p + b_c);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (m0 + 16 * mt < Kp) {
              mma_step(c[mt][2 * p], a[mt], b[0], b[1]);
              mma_step(c[mt][2 * p + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = m0 + 16 * mt + g + 8 * (e >> 1), n = n0 + 8 * nt + 2 * t + (e & 1);
          if (k < K && n < N) dst[(size_t)k * N + n] = old[mt][nt][e] + c[mt][nt][e];
        }
  }
}

// dst (K, N) (+)= A^T C for a narrow f32 cotangent C (BM x N, row stride 8,
// N <= 3): one entry per thread, rows in order.
// The sums over the tile's rows below keep four partial sums (rows r with
// r % 4 = 0..3) and add them in a fixed order: a quarter of the dependent
// chain of one sum.
__device__ inline void narrow_wgrad(float* __restrict__ dst, const bf16* A, int lda, int K,
                                    const float* C, int N, bool first) {
  for (int e = threadIdx.x; e < K * N; e += NT) {
    const int k = e / N, j = e - k * N;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(bf(A[(r + i) * lda + k]), C[(r + i) * 8 + j], s[i]);
    const float v = (s[0] + s[1]) + (s[2] + s[3]);
    dst[e] = first ? v : dst[e] + v;
  }
}

// dst (N) (+)= column sums of a bf16 gradient tile / an f32 cotangent.
__device__ inline void bgrad(float* __restrict__ dst, const bf16* G, int ldg, int N, bool first) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; r += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += bf(G[(r + i) * ldg + n]);
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
  bf16* P;     // activations (BM x LDH)
  bf16* G;     // gradients (BM x LDH), backward only
  bf16* X;     // encoded xyz (BM x LDX)
  bf16* D;     // encoded view dirs (BM x LDD)
  bf16* ring;  // NSTAGE x HPAD x LDW
  float* sig;  // sigma of each row (BM), forward output
  float* GI;   // output cotangent (BM x 8): grgb | gsig | bf16(gsig), backward only
};

template <int WM = 2>
constexpr size_t fwd_smem_bytes() {
  constexpr size_t rows = BM_OF<WM>;
  return 2 * (rows * LDH + rows * LDX + rows * LDD + NSTAGE * HPAD * LDW) + 4 * rows;
}
constexpr size_t bwd_smem_bytes() { return fwd_smem_bytes() + 2 * BM * LDH + 4 * BM * 8; }
static_assert(bwd_smem_bytes() <= 232448, "the backward tiles must fit a block's shared memory");

template <int WM = 2>
__device__ inline Tiles make_tiles(void* smem, bool backward) {
  Tiles t;
  t.P = static_cast<bf16*>(smem);
  t.X = t.P + BM_OF<WM> * LDH;
  t.D = t.X + BM_OF<WM> * LDX;
  t.ring = t.D + BM_OF<WM> * LDD;
  t.G = t.ring + NSTAGE * HPAD * LDW;
  t.sig = reinterpret_cast<float*>(backward ? t.G + BM_OF<WM> * LDH : t.G);
  t.GI = t.sig + BM_OF<WM>;
  if (!backward) t.G = nullptr;
  return t;
}

// Rows [row0, row0 + BM_OF<WM>) of a (n, width) bf16 or f32 array into a
// tile of stride ld (f32 values rounded to bf16 as they are stored); columns
// [width, pad16(width)) and rows past n are zero.
template <int WM = 2, typename Src = bf16>
__device__ inline void load_tile(bf16* dst, int ld, const Src* __restrict__ src, int width,
                                 int row0, int n) {
  const int wp = pad16(width);
  for (int i = threadIdx.x; i < BM_OF<WM> * wp; i += NT_OF<WM>) {
    const int r = i / wp, c = i - r * wp;
    const bool in = row0 + r < n && c < width;
    if constexpr (std::is_same<Src, bf16>::value)
      dst[r * ld + c] = in ? src[(size_t)(row0 + r) * width + c] : __float2bfloat16_rn(0.f);
    else
      dst[r * ld + c] = __float2bfloat16_rn(in ? src[(size_t)(row0 + r) * width + c] : 0.f);
  }
}

// GI from the (n, 4) f32 cotangent; rows past n are zero.
__device__ inline void load_cotangent(float* GI, const float* __restrict__ g, int row0, int n) {
  for (int i = threadIdx.x; i < BM * 4; i += NT) {
    const int r = i >> 2, c = i & 3;
    const float v = row0 + r < n ? g[(size_t)(row0 + r) * 4 + c] : 0.f;
    GI[r * 8 + c] = v;
    if (c == 3) GI[r * 8 + 4] = round_bf(v);
  }
}

// The first `width` (a multiple of 16) columns of P to / from an activation
// slot (BM x HPAD) in global memory, 16 bytes a copy.
template <int WM = 2>
__device__ inline void store_slot(bf16* __restrict__ slot, const bf16* P, int width) {
  const int vecs = width / 8;
  for (int i = threadIdx.x; i < BM_OF<WM> * vecs; i += NT_OF<WM>) {
    const int r = i / vecs, v = i - r * vecs;
    *reinterpret_cast<uint4*>(slot + r * HPAD + v * 8) =
        *reinterpret_cast<const uint4*>(P + r * LDH + v * 8);
  }
}
// Ends with every copy landed and a barrier.
__device__ inline void load_slot(bf16* P, const bf16* __restrict__ slot, int width) {
  const int vecs = width / 8;
  for (int i = threadIdx.x; i < BM * vecs; i += NT) {
    const int r = i / vecs, v = i - r * vecs;
    cp_async16(P + r * LDH + v * 8, slot + r * HPAD + v * 8);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// The epilogue of a hidden layer, as a policy of store_leaky: the value that
// a pre-activation sum `acc` leaves in P before its bf16 rounding. This one is
// the network's, leaky(acc + bias); the epilogue probe (probe_mlp_epilogue.cu)
// supplies others.
struct LeakyEpilogue {
  static __device__ __forceinline__ float apply(float acc, float bias, float alpha) {
    const float v = acc + bias;
    return v >= 0.f ? v : alpha * v;
  }
};

// P = bf16(Epi(acc, bias)) over the product's np (padded) columns; the pad
// columns get bias 0 (and with the network's epilogue hold 0).
template <typename Epi = LeakyEpilogue, int WM = 2>
__device__ __forceinline__ void store_leaky(const Acc& acc, const float* __restrict__ bias, int N,
                                            int np, float alpha, bf16* P) {
  const FragOf<WM> f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (16 * f.pair(q) >= np) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = f.col(q, h);
      const float b0 = n < N ? bias[n] : 0.f, b1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v0 = Epi::apply(acc[mt][q][h][2 * half], b0, alpha);
          const float v1 = Epi::apply(acc[mt][q][h][2 * half + 1], b1, alpha);
          store_pair(P + f.row(mt, half) * LDH + n, v0, v1);
        }
    }
  }
}

// G = leaky'(post) * acc for the np columns (0 past N). Trunk: bf16(g or
// alpha g), f32 slope. Head (head = true): t = bf16(acc), then t or
// bf16(alpha_t t) with the slope alpha_t rounded to bf16. Each slope of the
// N columns goes to the sink as hidden layer `layer`'s (branch_sink.cuh).
template <class Sink>
__device__ __forceinline__ void grad_tile(const Acc& acc, const bf16* post, int N, int np,
                                          float alpha, bool head, bf16* G, int layer) {
  const Frag f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (16 * f.pair(q) >= np) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = f.col(q, h);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = f.row(mt, half);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[mt][q][h][2 * half + e];
            const bool pos = bf(post[r * LDH + n + e]) >= 0.f;
            if (n + e < N) Sink::record(layer, r, n + e, pos);
            if (head) {
              const float tt = round_bf(a);
              v[e] = pos ? tt : round_bf(alpha * tt);
            } else {
              v[e] = pos ? a : alpha * a;
            }
            if (n + e >= N) v[e] = 0.f;
          }
          store_pair(G + r * LDH + n, v[0], v[1]);
        }
    }
  }
}

// acc += c[r] w[n] for n < N: a K = 1 product (c = GI column 4, w a column
// of the B pack with row stride 16).
__device__ __forceinline__ void add_rank1(Acc& acc, const float* GI, const bf16* __restrict__ w,
                                          int N) {
  const Frag f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = f.col(q, h) + e;
        if (n >= N) continue;
        const float wn = bf(w[n * 16]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            acc[mt][q][h][2 * half + e] =
                fmaf(GI[f.row(mt, half) * 8 + 4], wn, acc[mt][q][h][2 * half + e]);
      }
}

// Global (n, N) f32 rows [row0, row0 + BM) = acc (+ their old value, if add);
// rows past n and columns past N are not written.
__device__ __forceinline__ void store_rows(const Acc& acc, float* __restrict__ dst, int N,
                                          int row0, int n_rows, bool add) {
  const Frag f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + f.row(mt, half);
      if (r >= n_rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = f.col(q, h) + e;
            if (c < N) {
              float* p = dst + (size_t)r * N + c;
              const float v = acc[mt][q][h][2 * half + e];
              *p = add ? v + *p : v;
            }
          }
    }
}

// --------------------------------------------------------------------------
// Forward tile

// The whole network on one row tile whose X and D are loaded (and a barrier
// passed) and whose first chunk (F pack, matrix 0) is issued into the ring.
// With `keep`, post-activations go to its NACT slots (trunk 0..7, then the
// rgb branch's hidden layers). With `out`, the (n, 4) raw rows are written.
// `after`: the product whose first chunk to issue during the last one. `Epi`
// is the epilogue of every hidden layer (the two output heads add their f32
// bias only); the tile has WM row halves.
template <typename Epi = LeakyEpilogue, int WM = 2>
__device__ inline void forward_tile(const Dims& dm, const Layout& L, const MmaLayout& M,
                                    const bf16* __restrict__ F, const float* __restrict__ B,
                                    const Tiles& t, Ring& ring, bf16* keep, float* out, int row0,
                                    const Mat* after) {
  const float alpha = dm.alpha;
  Acc acc;
  for (int l = 0; l < N_TRUNK; ++l) {
    const int i = trunk_w(l);
    zero_acc(acc);
    if (l == SKIP) {
      const Mat nx = fmat(F, M, SKIP + 1);
      mma_rows<WM>(acc, t.X, LDX, fmat(F, M, SKIP), &nx, ring);
    }
    const Mat nx = fmat(F, M, i + 1);
    mma_rows<WM>(acc, l == 0 ? t.X : t.P, l == 0 ? LDX : LDH, fmat(F, M, i), &nx, ring);
    store_leaky<Epi, WM>(acc, B + L.b[l], dm.hid, M.np[i], alpha, t.P);
    __syncthreads();
    if (keep) store_slot<WM>(keep + l * SLOT, t.P, M.np[i]);
  }
  // Narrow heads read h8 (in P) before the rgb branch overwrites it: sigma,
  // two threads per row, each over every other column.
  const int tid = threadIdx.x, r = tid >> 1, hf = tid & 1;
  if (out) {
    const bf16* wh = F + M.off[12];
    float sh = 0.f, sd = 0.f;
    for (int k = hf; k < dm.hid; k += 2) sh = fmaf(bf(t.P[r * LDH + k]), bf(wh[k]), sh);
    if (dm.has_dir) {
      const bf16* wd = F + M.off[13];
      for (int k = hf; k < dm.dir; k += 2) sd = fmaf(bf(t.D[r * LDD + k]), bf(wd[k]), sd);
    }
    sh += __shfl_xor_sync(0xffffffffu, sh, 1);
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    if (hf == 0) t.sig[r] = dm.has_dir ? (sh + sd) + B[L.b[10]] : sh + B[L.b[11]];
  }
  zero_acc(acc);
  if (dm.has_dir) {
    const Mat nx = fmat(F, M, 10);
    mma_rows<WM>(acc, t.P, LDH, fmat(F, M, 9), &nx, ring);
    mma_rows<WM>(acc, t.D, LDD, fmat(F, M, 10), after, ring);
    store_leaky<Epi, WM>(acc, B + L.b[8], dm.last, M.np[9], alpha, t.P);
    __syncthreads();
    if (keep) store_slot<WM>(keep + 8 * SLOT, t.P, M.np[9]);
  } else {
    const Mat nx = fmat(F, M, 10);
    mma_rows<WM>(acc, t.P, LDH, fmat(F, M, 9), &nx, ring);
    store_leaky<Epi, WM>(acc, B + L.b[8], dm.hid, M.np[9], alpha, t.P);
    __syncthreads();
    if (keep) store_slot<WM>(keep + 8 * SLOT, t.P, M.np[9]);
    zero_acc(acc);
    mma_rows<WM>(acc, t.P, LDH, fmat(F, M, 10), after, ring);
    store_leaky<Epi, WM>(acc, B + L.b[9], dm.last, M.np[10], alpha, t.P);
    __syncthreads();
    if (keep) store_slot<WM>(keep + 9 * SLOT, t.P, M.np[10]);
  }
  if (out) {
    // rgb = rgb_h @ Wro + bro; Wro^T in the F pack, row stride kp[11].
    const bf16* wo = F + M.off[11];
    const int ko = M.kp[11];
    float s[3] = {0.f, 0.f, 0.f};
    for (int k = hf; k < dm.last; k += 2) {
      const float a = bf(t.P[r * LDH + k]);
#pragma unroll
      for (int j = 0; j < 3; ++j) s[j] = fmaf(a, bf(wo[j * ko + k]), s[j]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
    if (hf == 0 && row0 + r < dm.n) {
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

// The chain back over one tile whose forward kept its post-activations in
// `acts` (the NACT slots, as forward_tile keeps them), with X, D and GI
// loaded, P holding the rgb branch's last post-activation (the forward's
// last; slot 8 with view dirs, 9 without), a barrier passed and the B pack's
// matrix 10 (`b10`) issued into the ring. Weight and bias gradients go to the
// block's slab `part` (weights, then biases), written on its first tile
// (`first`) and added to after; dx and dd rows to global memory (dd where
// given). `after`: the product whose first chunk to issue during the last.
// Every leaky slope taken goes to `Sink` (branch_sink.cuh), as hidden layer
// 0-7 (trunk), then 8 (rgb_h with view dirs; r0 without) and 9 (rgb_h
// without view dirs).
template <class Sink>
__device__ inline void backward_walk(const Dims& dm, const Layout& L, const MmaLayout& M,
                                     const bf16* __restrict__ Bp, const Tiles& t, Ring& ring,
                                     const bf16* acts, float* part, bool first, int row0,
                                     float* dx, float* dd, const Mat* after, const Mat& b10) {
  const float alpha = dm.alpha;
  const float alpha_t = round_bf(alpha);
  const int HP = pad16(dm.hid), LP = pad16(dm.last);
  float* pb = part + L.total_w;

  // rgb_out (last, 3): its weight and bias gradients, then g_rgb_h =
  // head_grad(grgb @ Wro^T) with K = 3 in f32 (Wro in the B pack, row stride 16).
  narrow_wgrad(part + L.w[11], t.P, LDH, dm.last, t.GI, 3, first);
  narrow_bgrad(pb + L.b[dm.has_dir ? 9 : 10], t.GI, 3, first);
  {
    const bf16* wo = Bp + M.off[11];
    for (int i = threadIdx.x; i < BM * LP; i += NT) {
      const int r = i / LP, n = i - r * LP;
      float v = 0.f;
      if (n < dm.last) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) s = fmaf(t.GI[r * 8 + j], bf(wo[n * 16 + j]), s);
        const float tt = round_bf(s);
        const bool pos = bf(t.P[r * LDH + n]) >= 0.f;
        Sink::record(dm.has_dir ? 8 : 9, r, n, pos);
        v = pos ? tt : round_bf(alpha_t * tt);
      }
      t.G[r * LDH + n] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  Acc acc;
  if (dm.has_dir) {
    load_slot(t.P, acts + 7 * SLOT, HP);  // h8
    mma_wgrad(part + L.w[9], t.P, LDH, dm.hid, t.G, LDH, dm.last, first);
    mma_wgrad(part + L.w[10], t.D, LDD, dm.dir, t.G, LDH, dm.last, first);
    bgrad(pb + L.b[8], t.G, LDH, dm.last, first);
    narrow_wgrad(part + L.w[12], t.P, LDH, dm.hid, t.GI + 3, 1, first);
    narrow_wgrad(part + L.w[13], t.D, LDD, dm.dir, t.GI + 3, 1, first);
    narrow_bgrad(pb + L.b[10], t.GI + 3, 1, first);
    // dd = g_rgb_h @ Wrh_d^T + gsig @ Wsig_d^T
    const Mat b9 = bmat(Bp, M, 9), b8 = bmat(Bp, M, 8);
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b10, &b9, ring);
    add_rank1(acc, t.GI, Bp + M.off[13], dm.dir);
    if (dd) store_rows(acc, dd, dm.dir, row0, dm.n, false);
    // g_h8 = g_rgb_h @ Wrh_h^T + gsig @ Wsig_h^T
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b9, &b8, ring);
    add_rank1(acc, t.GI, Bp + M.off[12], dm.hid);
  } else {
    load_slot(t.P, acts + 8 * SLOT, HP);  // r0
    mma_wgrad(part + L.w[10], t.P, LDH, dm.hid, t.G, LDH, dm.last, first);
    bgrad(pb + L.b[9], t.G, LDH, dm.last, first);
    const Mat b9 = bmat(Bp, M, 9), b8 = bmat(Bp, M, 8);
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b10, &b9, ring);
    grad_tile<Sink>(acc, t.P, dm.hid, HP, alpha_t, true, t.G, 8);  // g_r0
    __syncthreads();
    load_slot(t.P, acts + 7 * SLOT, HP);  // h8
    mma_wgrad(part + L.w[9], t.P, LDH, dm.hid, t.G, LDH, dm.hid, first);
    bgrad(pb + L.b[8], t.G, LDH, dm.hid, first);
    narrow_wgrad(part + L.w[12], t.P, LDH, dm.hid, t.GI + 3, 1, first);
    narrow_bgrad(pb + L.b[11], t.GI + 3, 1, first);
    // g_h8 = g_r0 @ Wrh0^T + gsig @ Wsig^T
    zero_acc(acc);
    mma_rows(acc, t.G, LDH, b9, &b8, ring);
    add_rank1(acc, t.GI, Bp + M.off[12], dm.hid);
  }

  // Trunk, reversed; acc holds the gradient of layer l's output and P its
  // post-activation.
  for (int l = N_TRUNK - 1; l >= 0; --l) {
    grad_tile<Sink>(acc, t.P, dm.hid, HP, alpha, false, t.G, l);
    __syncthreads();
    if (l > 0) load_slot(t.P, acts + (l - 1) * SLOT, HP);
    bgrad(pb + L.b[l], t.G, LDH, dm.hid, first);
    const int i = trunk_w(l);
    if (l == SKIP) {
      mma_wgrad(part + L.w[SKIP], t.X, LDX, dm.xyz, t.G, LDH, dm.hid, first);
      mma_wgrad(part + L.w[SKIP + 1], t.P, LDH, dm.hid, t.G, LDH, dm.hid, first);
      // The skip layer's share of dx goes to dx now; layer 0 adds its own.
      const Mat b5 = bmat(Bp, M, SKIP + 1), b3 = bmat(Bp, M, SKIP - 1);
      zero_acc(acc);
      mma_rows(acc, t.G, LDH, bmat(Bp, M, SKIP), &b5, ring);
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
      store_rows(acc, dx, dm.xyz, row0, dm.n, true);
    }
  }
}

// The backward of one tile whose X, D and GI are loaded (and a barrier
// passed) and whose first forward chunk is issued: the forward recomputed
// into `acts` (the block's NACT slots), then backward_walk.
template <class Sink>
__device__ inline void backward_tile(const Dims& dm, const Layout& L, const MmaLayout& M,
                                     const bf16* __restrict__ F, const bf16* __restrict__ Bp,
                                     const float* __restrict__ B, const Tiles& t, Ring& ring,
                                     bf16* acts, float* part, bool first, int row0, float* dx,
                                     float* dd, const Mat* after) {
  const Mat b10 = bmat(Bp, M, 10);
  forward_tile(dm, L, M, F, B, t, ring, acts, nullptr, row0, &b10);
  backward_walk<Sink>(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, after, b10);
}

}  // namespace nerf_mma

// Elements of each weight pack (the wrappers check theirs against it).
extern "C" long long nerf_mlp_mma_pack_elems(int has_dir, int xyz, int dir, int hid, int last) {
  const nerf_mlp::Dims dm{0, xyz, dir, hid, last, has_dir, 0.f};
  return nerf_mma::make_mma_layout(nerf_mlp::make_layout(dm)).total;
}
