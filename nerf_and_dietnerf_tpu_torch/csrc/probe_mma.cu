// P1: sustained rate of a chain of (M, 256) x (256, 256) bf16 products on the
// tensor cores, with nothing read from device memory inside the chain.
//
// Replaces tools/exp_mxu.py `run` (body `make_kernel`). Per grid step, for
// each of `n_chains` chains c: h_c (M, 256) = bf16(col * 0.001 (c + 1)), then
// depth / n_chains times h_c <- bf16(bf16(h_c @ W, f32 sums) * bf16(0.01));
// the step's result is the column sums over the M rows of sum_c f32(h_c),
// written to 8 equal rows: (steps * 8, 256) f32. Every step computes the same
// thing; the steps only repeat the work.
//
// What bounds it on an H100: operations on the tensor cores, 2 M 256 256
// depth FLOP a step: at the tools' first case (2048, 32, 1) over 8 steps 68.7
// GFLOP, 0.0695 ms at 989 TFLOP/s (W, 128 KB, is read once a block).
//
// Why `mma.sync` stopped at half the peak (the former design: a warp owned
// 16 rows, `mma.sync.m16n8k16` products with W^T in shared memory): each mma
// fetched its own 256 bytes of B from shared memory, and a 16-row A tile
// reuses none of them. An SM read 1 MiB of shared memory a layer of 128 rows,
// 8,192 clocks at 128 bytes a clock, against 4,096 clocks of tensor work:
// 0.212 ms at (2048, 32, 1) on an H100 SXM.
//
// What this design does about that: the products are bf16 `wgmma`
// (wgmma_bf16.cuh), m64n256k16 with A from registers and B from shared
// memory by descriptor. One `wgmma` reads a k-step of W (8 KB) once for 64
// rows, 4x fewer bytes than `mma.sync` for the same products, so the tensor
// cores set the pace (an m64n256k16 takes 128 clocks of an SM, its B read 64).
// - W sits in shared memory for the whole run in the K-major no-swizzle
//   layout of the descriptor (kmajor_offset), which the wrapper builds in
//   global memory (ops/probe_kernels_cuda.mxu_pack); one thread moves it in
//   with a bulk copy a k-step, counted by one mbarrier.
// - A warpgroup owns the 64 rows of one unit: a (row tile, chain) pair of a
//   grid step. A layer is 16 `wgmma` (the first with scale-d 0) into one
//   128-register accumulator, one commit and one wait. Its f32 result is
//   rounded, scaled and packed in place into the next layer's A fragments (64
//   registers; acc_to_frags): nothing goes back to shared memory.
// - The chain is dependent, so one warpgroup cannot overlap its own layers.
//   Two warpgroups a block (one block an SM, W shared) walk units on their
//   own: one converts its accumulator while the other's products run. Two
//   warpgroups that start together stay in step (equal layers, one tensor
//   pipe) and convert at the same time, the tensor cores idle meanwhile; so
//   warpgroup 1 starts its first layer when warpgroup 0's first layer is
//   done (a named barrier, passed once by each), and from then on each one's
//   conversion falls under the other's products. The
//   independent chains of a case are units of their own, so (512, 32, 4)
//   gives 256 units of 8 layers where a unit of all four chains would give
//   64 of 32, half the SMs idle.
// - Rows of a 64-row tile past m (m is a multiple of 16, so whole warps) are
//   computed and left out of the sums. Each unit writes its column sums to a
//   partial row (its warps added in warp order); a second launch adds a
//   step's units in unit order. Bitwise reproducible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using namespace nerf_wgmma;

constexpr int WIDTH = 256;                // columns of h, rows and columns of W
constexpr int KSTEPS = WIDTH / KSTEP;
constexpr int WGS = 2;                    // warpgroups of a block
constexpr int NT = 128 * WGS;
constexpr int TILE_ROWS = 64;             // rows of a unit: one warpgroup's product rows
constexpr uint32_t W_BYTES = WIDTH * WIDTH * 2;
constexpr uint32_t KSTEP_BYTES = kstep_bytes(WIDTH);
constexpr uint32_t SUM_BYTES = WGS * 4 * WIDTH * 4;  // a column-sum row per warp
constexpr size_t SMEM_BYTES = (size_t)W_BYTES + SUM_BYTES + 8;
static_assert(SMEM_BYTES <= 232448, "W and the column sums must fit a block's shared memory");
static_assert(KSTEP_BYTES * KSTEPS == W_BYTES, "a bulk copy a k-step");

// Two entries of a layer's sums as the next layer's bf16 pair:
// bf16(bf16(p) * bf16(0.01)); the product of two bf16 values is exact in f32,
// so it is rounded once.
__device__ __forceinline__ uint32_t scale_round(float p0, float p1, float s) {
  const float2 r = unpack_bf16(pack_bf16(p0, p1));
  return pack_bf16(r.x * s, r.y * s);
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The stagger of the two warpgroups: warpgroup 0 arrives once its first
// layer is done (or, with no layer to run, when it has none left), warpgroup
// 1 waits there before its first layer (or at its end); each passes once.
constexpr int STAGGER_BAR = 1 + WGS;
__device__ __forceinline__ void stagger(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive %0, %1;\n" ::"n"(STAGGER_BAR), "n"(NT) : "memory");
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(STAGGER_BAR), "n"(NT) : "memory");
}

__global__ void __launch_bounds__(NT, 1)
    mma_chain_kernel(const __nv_bfloat16* __restrict__ wpack, float* __restrict__ partial, int m,
                     int iters, int n_chains, int tiles_per_step, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* colsum = reinterpret_cast<float*>(smem + W_BYTES);  // (WGS, 4, WIDTH)
  const uint32_t w_s = saddr(smem), bar = saddr(smem + W_BYTES + SUM_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, W_BYTES);
    for (int kk = 0; kk < KSTEPS; ++kk)
      bulk_copy(w_s + kk * KSTEP_BYTES, wpack + kk * (KSTEP_BYTES / 2), KSTEP_BYTES, bar);
  }
  mbar_wait(bar, 0);

  const float s = __bfloat162float(__float2bfloat16_rn(0.01f));
  const uint64_t desc0 = make_desc(w_s, GROUP_BYTES);
  float* my_sum = colsum + (wg * 4 + warp) * WIDTH;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;  // defined before the first product reads it
  bool staggered = false;

  for (int unit = blockIdx.x * WGS + wg; unit < units; unit += gridDim.x * WGS) {
    const int chain = unit % n_chains;
    const int tile = (unit / n_chains) % tiles_per_step;
    const bool rows_in = tile * TILE_ROWS + warp * 16 < m;
    // h_c: every row is bf16(col * scale). a[kk] is the A fragment of columns
    // 16 kk .. 16 kk + 15: {row g | row g + 8} x {cols 2t, 2t+1 | 2t+8, 2t+9}.
    const float scale = (float)(0.001 * (double)(chain + 1));
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = 16 * kk + 2 * t;
      a[kk][0] = a[kk][1] = pack_bf16((float)col * scale, (float)(col + 1) * scale);
      a[kk][2] = a[kk][3] = pack_bf16((float)(col + 8) * scale, (float)(col + 9) * scale);
    }
    for (int it = 0; it < iters; ++it) {
      if (wg == 1 && !staggered) {
        stagger(wg);
        staggered = true;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n256k16(d, a[kk], desc0 + (uint64_t)(kk * (KSTEP_BYTES >> 4)), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      if (wg == 0 && !staggered) {
        stagger(wg);
        staggered = true;
      }
      acc_to_frags<WIDTH>(d, a, [s](float p0, float p1) { return scale_round(p0, p1, s); });
    }
    // The unit's column sums: rows g and g + 8 in the thread, the eight row
    // groups of the warp by shuffles, then the four warps in warp order.
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 top = unpack_bf16(a[kk][2 * half]);
        const float2 bot = unpack_bf16(a[kk][2 * half + 1]);
        float v0 = top.x + bot.x, v1 = top.y + bot.y;
#pragma unroll
        for (int mask = 4; mask < 32; mask <<= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, mask);
          v1 += __shfl_xor_sync(0xffffffffu, v1, mask);
        }
        if (g == 0) {
          const int col = 16 * kk + 8 * half + 2 * t;
          my_sum[col] = rows_in ? v0 : 0.f;
          my_sum[col + 1] = rows_in ? v1 : 0.f;
        }
      }
    }
    warpgroup_sync(wg);
    for (int col = tid & 127; col < WIDTH; col += 128) {
      const float* c = colsum + wg * 4 * WIDTH + col;
      partial[(size_t)unit * WIDTH + col] = ((c[0] + c[WIDTH]) + c[2 * WIDTH]) + c[3 * WIDTH];
    }
    warpgroup_sync(wg);
  }
  if (!staggered) stagger(wg);
}

// out[step * 8 + i, n] = sum over the step's units, in unit order.
__global__ void mma_chain_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                 int units_per_step) {
  const int step = blockIdx.x, n = threadIdx.x;
  float total = 0.f;
  for (int u = 0; u < units_per_step; ++u)
    total += partial[((size_t)step * units_per_step + u) * WIDTH + n];
  for (int i = 0; i < 8; ++i) out[((size_t)step * 8 + i) * WIDTH + n] = total;
}

}  // namespace

// Rows of a unit: `partial` holds steps * ceil(m / this) * n_chains rows of 256 floats.
extern "C" int nerf_probe_mma_unit_rows() { return TILE_ROWS; }

// w: the (256, 256) bf16 W in the K-major layout of kmajor_offset (np = 256);
// out (steps * 8, 256) f32; m a multiple of 16; n_blocks: the persistent
// grid, at most one block per SM (the kernel takes at most one per two
// units). Returns cudaGetLastError() after the launches (0 on success).
extern "C" int nerf_probe_mma(const void* w, float* partial, float* out, int m, int depth,
                              int n_chains, int steps, int n_blocks, void* stream) {
  if (m <= 0 || m % 16 || n_chains <= 0 || steps <= 0 || n_blocks <= 0 || depth < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_per_step = (m + TILE_ROWS - 1) / TILE_ROWS;
  const int units = steps * tiles_per_step * n_chains;
  cudaFuncSetAttribute(mma_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  mma_chain_kernel<<<min(n_blocks, (units + WGS - 1) / WGS), NT, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(w), partial, m, depth / n_chains, n_chains,
      tiles_per_step, units);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mma_chain_reduce<<<steps, WIDTH, 0, s>>>(partial, out, tiles_per_step * n_chains);
  return (int)cudaGetLastError();
}
