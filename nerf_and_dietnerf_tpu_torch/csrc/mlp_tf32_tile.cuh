// f32 device code of the radiance-MLP forward B1 (mlp_fwd.cu) on Hopper's
// tensor cores: 3xTF32 `wgmma` products with true-f32 accuracy, the weights
// streamed by bulk copies through a ring that a producer warp keeps full.
//
// Replaces the f32 instance of nerf_and_dietnerf_tpu/ops/raymarch_pallas.py
// `_forward_pallas` (body `_forward_tile`), which the eval renders and video
// frames run (they stay in f32: bf16 costs about 3 dB of PSNR on a frame).
// The f32 ray-march forward B6 (raymarch_fwd.cu) runs the same tile on inputs
// it builds itself (an `In` policy, see GlobalInputs and raymarch_tile.cuh).
// bf16 B1/B2/B4-B7 run the `mma.sync` tiles of mlp_mma_tile.cuh; every f32
// backward (B2, B4, B5, B6, B7) the 3xTF32 `mma.sync` tiles of
// mlp_tf32_mma_tile.cuh; f32 B4's and B7's forwards keep the FMA tile of
// mlp_common.cuh.
//
// What bounds it on an H100: operations. The forward is 1.024 MFLOP a row at
// the flagship widths (33 -> 8 x 256 -> 280 -> 128 -> 3); true f32 on the
// tensor cores takes three TF32 products for each, 3 x 268.4 GFLOP per
// 262,144 rows at the 495 TFLOP/s TF32 peak: 1.63 ms.
//
// What the design does about that.
// - Split: v = hi + lo with hi = rna_tf32(v), lo = rna_tf32(v - hi) (v - hi
//   is exact in f32), for the activations in registers and, by the wrapper
//   with the same rounding, for the weights. Each product is lo.hi + hi.lo +
//   hi.hi, issued small terms first into one accumulator; a TF32 x TF32
//   product is exact in f32, so only the dropped lo.lo term (2^-22 relative)
//   and the accumulation differ from an f32 FMA chain. No raw f32 bits reach
//   the tensor core (it would truncate their 13 low bits).
// - Accumulation: the tensor core does not round its running sum to nearest
//   (it truncates), so a layer summed in one `wgmma` accumulator drifts from
//   the f32 chain by up to an ulp a product, in one direction. Each chunk's
//   products (16 contraction columns, 6 `wgmma`) go instead into a fresh
//   partial accumulator (scale-d 0 on the first), which is then added to the
//   layer's f32 sum with ordinary round-to-nearest adds. chip_smoke.py holds
//   the result against the chain evaluated in f64, beside the plain f32
//   version and the former FMA design.
// - Products: `wgmma.mma_async.m64nNk8.f32.tf32.tf32`, N = 64 or 128 (a
//   layer's width is padded to 64, 128 or 256; a 256-wide layer is two
//   128-column parts of each stage, the partial accumulator 64 registers),
//   A from registers, B from shared memory. Every product with N > 3 and
//   K > 3 runs there: the eight trunk
//   layers (the skip layer's x W4a + h W4b into one accumulator) and the rgb
//   branch's hidden layers ((h8 | d) -> last; xyz-only h8 -> hid -> last).
//   The rgb and sigma heads (N <= 3) are f32 FMAs in the epilogues.
// - Tile: BM = 128 rows a block, three warpgroups. Warpgroup 0 is the
//   producer (one thread issues the copies; `setmaxnreg` leaves it 24
//   registers), warpgroups 1 and 2 each own 64 rows and issue the products
//   with 240 registers a thread (the layer's sum 128, the partial 64, A
//   fragments 16; shared memory is addressed by 32-bit shared-window
//   addresses and sigma goes to `out` as soon as it is known, so nothing
//   spills). Both
//   consumers read every weight stage, so each stage serves 128 rows. Blocks
//   are persistent (one per SM) and walk row tiles; the producer runs ahead
//   into the next tile's first stages.
// - A operand: the activations stay f32 in shared memory, 128 x 256 with a
//   260-float row stride (B1; B6 adds 64 input columns: 324), so the eight
//   rows of an `ldmatrix` phase fall in eight 16-byte bank groups. `ldmatrix.x4` (16-bit units) loads a TF32 A
//   fragment as it is: lane l gets row l / 4, word l % 4 of each 8 x 4 block.
//   Warp w of a warpgroup reads and writes only rows 16 w .. 16 w + 15, the
//   rows of its A fragment and of its accumulator, so a layer's output is
//   written in place over its input with no barrier beyond `__syncwarp`. The
//   encoded inputs x (layer 0, the skip layer) and d (view layer, sigma) are
//   read from global memory straight into the fragments, so they need no
//   shared memory. Nothing is read through a descriptor that a generic store
//   wrote: the tile is read with `ldmatrix`, and the weight stages are
//   written by the bulk copies (the async proxy), so no `fence.proxy.async`
//   is needed.
// - Inputs: the tile reads its encoded inputs through a policy `In` (the
//   ring's depth In::NSTAGE, In::IN_COLS input columns at the end of every
//   activation-tile row, begin_tile / load / d_at). B1's GlobalInputs reads
//   x and d from global memory as above, with three ring stages and no input
//   columns; B6 builds its features into 64 input columns and runs two
//   stages. The consumers hold nothing of the policy in registers: a kernel
//   passes it as a `__grid_constant__` parameter, read where it is used, and
//   an input fragment is addressed from the warp's activation rows.
// - B operand, weights: the wrapper packs every product matrix W (K, N) as
//   W^T, K-major ("rows = outputs, columns = contraction", as the bf16 F
//   pack), K padded to a multiple of 8 and N to 64 / 128 / 256, twice: hi and
//   lo. A matrix is cut into chunks of KS = 16 contraction columns (the last
//   may be 8 wide); a chunk is stored exactly as a ring stage holds it, in
//   the no-swizzle K-major layout of the `wgmma` descriptor: core matrices of
//   8 rows x 4 columns (128 contiguous bytes, row r at 16 r bytes), the
//   kc / 4 core matrices of one 8-row group side by side (leading byte
//   offset 128, the next core matrix along K), the 8-row groups kc x 32 bytes
//   apart (stride byte offset). A core matrix is 128 contiguous bytes, so the
//   tensor core reads it from all 32 banks once with no swizzle. One
//   `cp.async.bulk` per pack moves a chunk into its stage; the stage's full
//   `mbarrier` counts the bytes. B1's ring: 3 stages of (hi, lo) at N = 256.
// - Per chunk a consumer loads and splits its A fragments (before waiting on
//   the stage, so the loads overlap the wait); per 128-column part it issues
//   3 `wgmma` per k8 step, commits, waits for its group and adds the
//   partial; then it releases the stage (one arrive per warp; the empty
//   barrier counts 8). The two consumers' products, waits and epilogues
//   interleave on the SM's tensor cores.
// - Epilogue: bias and leaky in f32 with no rounding, from the accumulator
//   (row 16 w + g + 8 h, column 8 j + 2 t + e in d[4 j + 2 h + e]) to the
//   tile. The pad columns of a layer get bias 0 and hold leaky(0) = 0, so the
//   next layer's padded products add exact zeros; rows past n read zero x and
//   d, and their outputs are not written.
// - Weight bytes from L2: the two packs are 4.12 MB at the flagship widths
//   (515,072 floats each, view dirs), read once per 128-row tile: 8.44 GB
//   per 262,144 rows (a 64-row tile per block would read 16.9 GB).
//
// Shared memory (bytes), B1: ring 3 x 2 x 256 x 16 x 4 = 98,304 + activations
// 128 x 260 x 4 = 133,120 + 6 mbarriers 48 = 231,472 of the 232,448 a block
// may use (B6: see raymarch_tile.cuh).
//
// The f32 backward B2 recomputes the forward on its own tile (3xTF32
// `mma.sync`, mlp_tf32_mma_tile.cuh), so its linearisation point differs
// from this kernel's output in the last bits; the gradient it gives is that
// of its own forward, which is as close to the f32 chain.
#pragma once

#include <stdint.h>

#include "mlp_common.cuh"

namespace nerf_tf32 {

using nerf_mlp::Dims;
using nerf_mlp::Layout;
using nerf_mlp::N_TRUNK;
using nerf_mlp::SKIP;
using nerf_mlp::trunk_w;

constexpr int BM = 128;                  // rows per tile: two consumer warpgroups of 64
constexpr int NT = 384;                  // producer warpgroup + two consumer warpgroups
constexpr int HPAD = 256;                // widest padded layer; rows of a ring stage
constexpr int ACT_COLS = HPAD + 4;       // activation columns of a tile row (and pad)
constexpr int KS = 16;                   // contraction columns of a full chunk
constexpr int N_PROD = 11;               // matrices 0..10 run on the tensor cores
constexpr int STAGE_FLOATS = HPAD * KS;  // one pack's half of a stage
constexpr uint32_t LBO_BYTES = 128;      // next core matrix along K
constexpr int PART = 128;                // widest partial product (columns)
// Registers a thread after the role split: 128 x 24 + 256 x 240 = 64,512 of
// the SM's 65,536 (the launch's 384 x 168).
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// A wait on a stage longer than this many clocks (about 9 s) means a lost
// copy or a broken pipeline: trap rather than hang the card.
constexpr long long WAIT_LIMIT = 1LL << 34;

__host__ __device__ constexpr int pad8(int v) { return (v + 7) & ~7; }
// N of the `wgmma` that computes a layer of width n.
__host__ __device__ constexpr int npad(int n) { return n <= 64 ? 64 : n <= 128 ? 128 : 256; }
// Stride byte offset of a chunk kc columns wide: the next 8-row group.
__host__ __device__ constexpr uint32_t sbo_bytes(int kc) { return 32u * kc; }

struct Tf32Layout {
  int off[N_PROD];  // float offset of matrix i in either pack
  int kp[N_PROD];   // pad8(K)
  int np[N_PROD];   // npad(N)
  int total;        // floats of one pack
  int heads;        // float offset of the head weights: after the hi and lo packs
};

// The weight buffer of the f32 kernel: the hi pack, the lo pack (each
// `total` floats), then the head matrices 11.. in the flat order of
// mlp_common.cuh (view: Wro, Wsig_h, Wsig_d; xyz-only: Wro, Wsig), f32.
inline Tf32Layout make_tf32_layout(const Layout& L) {
  Tf32Layout T{};
  for (int i = 0; i < N_PROD; ++i) {
    T.kp[i] = pad8(L.wk[i]);
    T.np[i] = npad(L.wn[i]);
    T.off[i] = T.total;
    T.total += T.kp[i] * T.np[i];
  }
  T.heads = 2 * T.total;
  return T;
}

// Float offset, within its matrix's block (np rows, kp columns), of entry
// (n, k) of W^T: chunk c = k / KS of width kc holds np x kc floats as
// 8 x 4 core matrices, those of an 8-row group side by side.
__host__ __device__ inline int stage_offset(int n, int k, int np, int kp) {
  const int c = k / KS, k0 = KS * c;
  const int kc = kp - k0 < KS ? kp - k0 : KS, kk = k - k0;
  return np * k0 + ((n >> 3) * (kc >> 2) + (kk >> 2)) * 32 + (n & 7) * 4 + (kk & 3);
}

// --------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory is addressed by 32-bit shared-window addresses throughout
// (bar: an mbarrier's, dst / p: a tile's), which keeps 64-bit generic
// pointers out of the consumers' registers.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait for the phase of `bar` with the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// `bytes` from global memory to shared memory, completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products (no instruction is emitted).
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(p));
}
__device__ __forceinline__ void st_shared_f2(uint32_t p, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(p), "f"(a), "f"(b) : "memory");
}

// v rounded to TF32, nearest with ties away from zero, low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// Each of the four f32 values (bit patterns) as hi + lo, both TF32.
__device__ __forceinline__ void split(const uint32_t (&v)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __uint_as_float(v[i]);
    hi[i] = tf32_rna(f);
    lo[i] = tf32_rna(f - __uint_as_float(hi[i]));
  }
}

// Shared-memory matrix descriptor, no swizzle (layout type 0), K-major.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO_BYTES >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N f32, the accumulator fragment) = scale_d x d + A (64 x 8 TF32,
// fragment a) x B^T (B: N x 8 TF32, K-major, at desc); scale_d 0 or 1.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// --------------------------------------------------------------------------
// The pipeline

// Position in a ring of NS stages: the stage a role uses next and the parity
// of its phase.
template <int NS>
struct Pipe {
  int stage;
  uint32_t phase;
  __device__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Shared memory (byte offsets) of a kernel whose inputs `In` read: the ring
// (In::NSTAGE stages), the activation tile (BM rows of LDA floats: the
// activations, then In::IN_COLS input columns), the barriers. A row stride of
// 16 bytes more than a multiple of 128 puts the eight rows an `ldmatrix`
// phase reads in eight 16-byte bank groups.
template <class In>
struct Smem {
  static constexpr int LDA = ACT_COLS + In::IN_COLS;
  static constexpr uint32_t ACT = 4u * In::NSTAGE * 2 * STAGE_FLOATS;
  static constexpr uint32_t BAR = ACT + 4u * BM * LDA;
  static constexpr size_t BYTES = BAR + 8 * 2 * In::NSTAGE;
  static_assert(BYTES <= 232448, "the f32 forward's tiles must fit a block's shared memory");
  static_assert((4 * LDA) % 128 == 16, "rows of an ldmatrix phase must not share bank groups");
};

template <class In>
constexpr size_t smem_bytes() {
  return Smem<In>::BYTES;
}

// Shared addresses of the ring's stages and barriers.
struct Ring {
  uint32_t buf;    // NSTAGE x (hi, lo) x STAGE_FLOATS floats
  uint32_t full;   // NSTAGE mbarriers: the stage's bytes have landed
  uint32_t empty;  // NSTAGE mbarriers: the stage's 8 consumer warps are done with it
  __device__ uint32_t stage(int i) const { return buf + 4 * i * 2 * STAGE_FLOATS; }
  __device__ uint32_t full_bar(int i) const { return full + 8 * i; }
  __device__ uint32_t empty_bar(int i) const { return empty + 8 * i; }
};

template <class In>
__device__ __forceinline__ Ring make_ring(uint32_t smem) {
  return Ring{smem, smem + Smem<In>::BAR, smem + Smem<In>::BAR + 8 * In::NSTAGE};
}

// The producer thread: every chunk of matrices 0..10 of every tile the block
// walks, in the order the consumers multiply them.
template <int NS>
__device__ inline void produce(const Tf32Layout& T, const float* __restrict__ W, const Ring& r,
                               int tiles) {
  Pipe<NS> p{0, 0};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int m = 0; m < N_PROD; ++m) {
      for (int k0 = 0; k0 < T.kp[m]; k0 += KS) {
        const int kc = min(KS, T.kp[m] - k0);
        const uint32_t bytes = 4u * T.np[m] * kc;
        mbar_wait(r.empty_bar(p.stage), p.phase ^ 1);
        mbar_expect_tx(r.full_bar(p.stage), 2 * bytes);
        const float* src = W + T.off[m] + T.np[m] * k0;
        const uint32_t dst = r.stage(p.stage);
        bulk_copy(dst, src, bytes, r.full_bar(p.stage));
        bulk_copy(dst + 4 * STAGE_FLOATS, src + T.total, bytes, r.full_bar(p.stage));
        p.advance();
      }
    }
  }
}

// What a consumer thread needs to address its rows.
struct Rows {
  uint32_t tile;  // shared address of the warp's 16 rows of the activation tile
  unsigned grow;  // global row of the thread's accumulator rows g (and g + 8)
  unsigned n;     // rows of the call
  int lane, g, t;
};

// The A operand of a product: the activation tile, or the encoded inputs x
// or d (read through the kernel's `In` policy).
enum Src { SRC_ACT, SRC_X, SRC_D };

__device__ __forceinline__ float ld_or_zero(const float* src, int width, const Rows& rw,
                                            unsigned r, int c) {
  return r < rw.n && c < width ? __ldg(src + (size_t)r * width + c) : 0.f;
}

// B1's inputs: global (n, xyz) and (n, dir) f32 arrays read straight into A
// fragments (rows past n and columns past the width read 0), so they need no
// shared memory; three ring stages.
struct GlobalInputs {
  static constexpr int NSTAGE = 3;
  static constexpr int IN_COLS = 0;
  const float* x;
  const float* d;
  int xyz, dir;
  __device__ void begin_tile(const Rows&) const {}
  // The A fragment (rows 16 w .. +16, columns k .. k + 8) of x or d as f32
  // bit patterns: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
  __device__ __forceinline__ void load(uint32_t (&a)[4], bool dir_cols, const Rows& rw,
                                       int k) const {
    const float* src = dir_cols ? d : x;
    const int width = dir_cols ? dir : xyz;
    a[0] = __float_as_uint(ld_or_zero(src, width, rw, rw.grow, k + rw.t));
    a[1] = __float_as_uint(ld_or_zero(src, width, rw, rw.grow + 8, k + rw.t));
    a[2] = __float_as_uint(ld_or_zero(src, width, rw, rw.grow, k + rw.t + 4));
    a[3] = __float_as_uint(ld_or_zero(src, width, rw, rw.grow + 8, k + rw.t + 4));
  }
  // d of the warp's row g + 8 h, column k.
  __device__ __forceinline__ float d_at(const Rows& rw, int h, int k) const {
    return ld_or_zero(d, dir, rw, rw.grow + 8 * h, k);
  }
};

// The A fragment of tile columns k .. k + 8 (the warp's rows 16 w .. +16)
// with `ldmatrix`: lane l addresses row (l & 7) + 8 ((l >> 3) & 1), columns
// k + 4 (l >> 4) .. + 4; rows LDA floats apart.
template <int LDA>
__device__ __forceinline__ void load_tile_a(uint32_t (&a)[4], const Rows& rw, int k) {
  const int row = (rw.lane & 7) + 8 * ((rw.lane >> 3) & 1);
  ldsm_x4(a, rw.tile + 4 * (row * LDA + k + 4 * (rw.lane >> 4)));
}

// The A fragment of source s (rows 16 w .. +16, columns k .. k + 8).
template <class In>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], Src s, const In& in, const Rows& rw,
                                       int k) {
  if (s == SRC_ACT) {
    load_tile_a<Smem<In>::LDA>(a, rw, k);
  } else {
    in.load(a, s == SRC_D, rw, k);
  }
}

// acc += A (the warpgroup's 64 rows, from s) @ matrix m, streamed through
// the ring. Per chunk and per SN-column part of the layer (SN = min(NP,
// 128)): three products per k8 step into a fresh partial accumulator (the
// first with scale-d 0), then wait, and the partial is added to acc with one
// f32 add each (round to nearest); then the stage is released.
template <int NP, class In>
__device__ __forceinline__ void product(float (&acc)[128], const Tf32Layout& T, int m, Src s,
                                        const In& in, const Rows& rw, const Ring& r,
                                        Pipe<In::NSTAGE>& p) {
  constexpr int SN = NP < PART ? NP : PART;
  float part[SN / 2];
#pragma unroll
  for (int i = 0; i < SN / 2; ++i) part[i] = 0.f;
  for (int k0 = 0; k0 < T.kp[m]; k0 += KS) {
    const int kc = min(KS, T.kp[m] - k0);
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (8 * j < kc) {
        uint32_t a[4];
        load_a(a, s, in, rw, k0 + 8 * j);
        split(a, hi[j], lo[j]);
      }
    }
    mbar_wait(r.full_bar(p.stage), p.phase);
    const uint32_t base = r.stage(p.stage);
    const uint32_t sbo = sbo_bytes(kc);
#pragma unroll
    for (int h = 0; h < NP / SN; ++h) {
      // Columns SN h .. SN h + SN: rows SN h / 8 core-matrix groups down.
      const uint32_t b0 = base + (SN / 8) * h * sbo;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (8 * j < kc) {
          const uint64_t b_hi = make_desc(b0 + 256 * j, sbo);
          const uint64_t b_lo = make_desc(b0 + 4 * STAGE_FLOATS + 256 * j, sbo);
          wgmma_tf32<SN>(part, lo[j], b_hi, j > 0);
          wgmma_tf32<SN>(part, hi[j], b_lo, 1);
          wgmma_tf32<SN>(part, hi[j], b_hi, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) acc[(SN / 2) * h + i] += part[i];
    }
    if (rw.lane == 0) mbar_arrive(r.empty_bar(p.stage));
    p.advance();
  }
}

__device__ __forceinline__ float leaky(float v, float alpha) { return v >= 0.f ? v : alpha * v; }

// The warp's rows of the tile = leaky(acc + bias) over the NP columns (pad
// columns: bias 0, value 0). With wsig, also sh[h] += that row's sum of
// value x wsig over the thread's columns (< N).
template <int NP, int LDA>
__device__ __forceinline__ void store_leaky(const float (&acc)[128], const float* __restrict__ bias,
                                            int N, float alpha, const Rows& rw,
                                            const float* __restrict__ wsig, float (&sh)[2]) {
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const int c = 8 * j + 2 * rw.t;
    const float b0 = c < N ? __ldg(bias + c) : 0.f, b1 = c + 1 < N ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = leaky(acc[4 * j + 2 * h] + b0, alpha);
      const float v1 = leaky(acc[4 * j + 2 * h + 1] + b1, alpha);
      st_shared_f2(rw.tile + 4 * ((rw.g + 8 * h) * LDA + c), v0, v1);
      if (wsig != nullptr) {
        if (c < N) sh[h] = fmaf(v0, __ldg(wsig + c), sh[h]);
        if (c + 1 < N) sh[h] = fmaf(v1, __ldg(wsig + c + 1), sh[h]);
      }
    }
  }
}

// s[h][q] += leaky(acc + bias) x wo[:, q] over the thread's columns (< N);
// wo: (N, 3) row-major.
template <int NP>
__device__ __forceinline__ void rgb_head(const float (&acc)[128], const float* __restrict__ bias,
                                         int N, float alpha, const Rows& rw,
                                         const float* __restrict__ wo, float (&s)[2][3]) {
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * rw.t + e;
      if (c >= N) continue;
      const float b = __ldg(bias + c);
      const float w0 = __ldg(wo + 3 * c), w1 = __ldg(wo + 3 * c + 1), w2 = __ldg(wo + 3 * c + 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = leaky(acc[4 * j + 2 * h + e] + b, alpha);
        s[h][0] = fmaf(v, w0, s[h][0]);
        s[h][1] = fmaf(v, w1, s[h][1]);
        s[h][2] = fmaf(v, w2, s[h][2]);
      }
    }
  }
}

// Sum over the four lanes of a row group (t = 0..3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
}

// Runs the call `...` with NP the constexpr `wgmma` width np (256, 128 or 64).
#define NERF_TF32_WIDTH(np, ...) \
  do {                            \
    if ((np) == 256) {            \
      constexpr int NP = 256;     \
      __VA_ARGS__;                \
    } else if ((np) == 128) {     \
      constexpr int NP = 128;     \
      __VA_ARGS__;                \
    } else {                      \
      constexpr int NP = 64;      \
      __VA_ARGS__;                \
    }                             \
  } while (0)

// acc = the products of one layer: matrix m[0] on s[0], then (if m[1] >= 0)
// matrix m[1] on s[1], into the one accumulator.
template <int NP, class In>
__device__ __forceinline__ void layer_products(float (&acc)[128], const Tf32Layout& T,
                                               const int (&m)[2], const Src (&s)[2],
                                               const In& in, const Rows& rw, const Ring& r,
                                               Pipe<In::NSTAGE>& p) {
  zero(acc);
  product<NP>(acc, T, m[0], s[0], in, rw, r, p);
  if (m[1] >= 0) product<NP>(acc, T, m[1], s[1], in, rw, r, p);
}

// Head matrix i (11..13) in the weight buffer.
__device__ __forceinline__ const float* head(const float* W, const Tf32Layout& T, const Layout& L,
                                             int i) {
  return W + T.heads + (L.w[i] - L.w[11]);
}

// A consumer warpgroup (wg = 0, 1: rows 64 wg .. +64 of each tile): the
// whole network on its rows of every tile the block walks; (n, 4) rows out.
// Layers: trunk 0..7, then view dirs: (h8 | d) -> last, the rgb head;
// xyz-only: h8 -> hid, then -> last, the rgb head. Layer l's bias is L.b[l].
// The warp reads its rows' inputs through `in`, after in.begin_tile.
template <class In>
__device__ inline void consume(const Dims& dm, const Layout& L, const Tf32Layout& T, const In& in,
                               const float* __restrict__ W, const float* __restrict__ B,
                               float* __restrict__ out, const Ring& r, int wg, int tiles) {
  const float alpha = dm.alpha;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  constexpr int LDA = Smem<In>::LDA;
  Rows rw{r.buf + Smem<In>::ACT + 4 * (64 * wg + 16 * warp) * LDA, 0, (unsigned)dm.n, lane,
          lane >> 2, lane & 3};
  // The head weights (Wro (last, 3), Wsig_h / Wsig (hid), Wsig_d (dir)) are
  // addressed where they are read, from the kernel's parameters.
  const int n_layers = N_TRUNK + (dm.has_dir ? 1 : 2);
  Pipe<In::NSTAGE> p{0, 0};
  float acc[128];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    rw.grow = tile * BM + 64 * wg + 16 * warp + rw.g;
    in.begin_tile(rw);
    float sh[2] = {0.f, 0.f};
    for (int l = 0; l < n_layers; ++l) {
      int m[2] = {l < N_TRUNK ? trunk_w(l) : 9, -1};
      Src s[2] = {l == 0 ? SRC_X : SRC_ACT, SRC_ACT};
      if (l == SKIP) {
        m[0] = SKIP;
        m[1] = SKIP + 1;
        s[0] = SRC_X;
      } else if (l == N_TRUNK + 1) {
        m[0] = 10;
      } else if (l == N_TRUNK && dm.has_dir) {
        m[1] = 10;
        s[1] = SRC_D;
      }
      NERF_TF32_WIDTH(T.np[m[0]], layer_products<NP>(acc, T, m, s, in, rw, r, p));
      if (l == n_layers - 1) break;
      // Every hidden layer but the last is hid wide; h8 (l = 7) also feeds
      // sigma, before the rgb branch overwrites it.
      NERF_TF32_WIDTH(T.np[m[0]], store_leaky<NP, LDA>(acc, B + L.b[l], dm.hid, alpha, rw,
                                                  l == N_TRUNK - 1 ? head(W, T, L, 12) : nullptr,
                                                  sh));
      __syncwarp();
      if (l == N_TRUNK - 1) {
        const int b_sig = dm.has_dir ? 10 : 11;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sd = 0.f;
          for (int k = rw.t; k < dm.dir; k += 4)
            sd = fmaf(in.d_at(rw, h, k), __ldg(head(W, T, L, 13) + k), sd);
          const float hid_part = quad_sum(sh[h]);
          const float sigma =
              (dm.has_dir ? hid_part + quad_sum(sd) : hid_part) + __ldg(B + L.b[b_sig]);
          // Written now, so that it is held in no register through the rgb branch.
          const unsigned row = rw.grow + 8 * h;
          if (rw.t == 0 && row < rw.n) out[(size_t)row * 4 + 3] = sigma;
        }
      }
    }
    // The last layer's accumulator: rgb = leaky(acc + b) @ Wro + bo.
    float s3[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    const int l_last = n_layers - 1;
    NERF_TF32_WIDTH(T.np[l_last == N_TRUNK ? 9 : 10],
                    rgb_head<NP>(acc, B + L.b[l_last], dm.last, alpha, rw, head(W, T, L, 11), s3));
    const float* bo = B + L.b[l_last + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float c0 = quad_sum(s3[h][0]), c1 = quad_sum(s3[h][1]), c2 = quad_sum(s3[h][2]);
      const unsigned row = rw.grow + 8 * h;
      if (rw.t == 0 && row < rw.n) {
        float* o = out + (size_t)row * 4;
        o[0] = c0 + __ldg(bo);
        o[1] = c1 + __ldg(bo + 1);
        o[2] = c2 + __ldg(bo + 2);
      }
    }
  }
}

// The kernel's body: barriers, then the producer / consumer split.
template <class In>
__device__ inline void forward(const Dims& dm, const Layout& L, const Tf32Layout& T, const In& in,
                               const float* __restrict__ W, const float* __restrict__ B,
                               float* __restrict__ out, void* smem) {
  if (threadIdx.x == 0) {
    const Ring r = make_ring<In>(saddr(smem));
    for (int i = 0; i < In::NSTAGE; ++i) {
      mbar_init(r.full_bar(i), 1);
      mbar_init(r.empty_bar(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (dm.n + BM - 1) / BM;
  // Each role derives its addresses after its `setmaxnreg`, from a base the
  // compiler cannot see through: nothing is computed before the split and
  // held across it.
  uint32_t base = saddr(smem);
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    asm volatile("" : "+r"(base));
    if (threadIdx.x == 0) produce<In::NSTAGE>(T, W, make_ring<In>(base), tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    asm volatile("" : "+r"(base));
    consume(dm, L, T, in, W, B, out, make_ring<In>(base), (threadIdx.x >> 7) - 1, tiles);
  }
}

}  // namespace nerf_tf32

// Floats of each TF32 pack (hi, lo) of the f32 forward (the wrapper checks
// its packs against it).
extern "C" long long nerf_mlp_tf32_pack_elems(int has_dir, int xyz, int dir, int hid, int last) {
  const nerf_mlp::Dims dm{0, xyz, dir, hid, last, has_dir, 0.f};
  return nerf_tf32::make_tf32_layout(nerf_mlp::make_layout(dm)).total;
}
