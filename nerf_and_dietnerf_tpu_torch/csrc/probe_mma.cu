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
// What bounds it on an H100: operations on the tensor cores
// (2 M 256 256 depth FLOP a step against 128 KB of W read once a block).
//
// What the design does about that: the products are `mma.sync.m16n8k16`
// (bf16 operands, f32 sums). A warp owns 16 rows for the whole chain and
// keeps them in registers: the 16 x 256 f32 result of a layer is laid out,
// thread by thread, exactly as the next layer's A operand needs it (the C
// fragments of n-tiles 2k and 2k + 1 are the A fragment of k-step k), so it
// is rounded, scaled and packed in place and never touches shared memory. W
// sits in shared memory for the whole run, transposed (pairs along k are one
// 32-bit word, as the B fragment wants) with a row stride of 264 so that a
// warp's fragment loads hit 32 different banks. Blocks are persistent: each
// loads W once and walks units of 128 rows. A grid step's rows are spread
// over several blocks, so the column sums go through per-unit partial rows
// that a second launch adds in a fixed order: bitwise reproducible. The
// chains of a warp run one after another; the 32 independent n-tiles of each
// k-step, and the other warps, are what keeps the tensor cores fed. Each mma
// needs its own 256 bytes of B from shared memory (a 16-row A tile reuses
// nothing), which caps this form at half the tensor-core peak; `wgmma`, which
// reads B once for 64 rows, is the way above that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDTH = 256;               // columns of h, rows and columns of W
constexpr int NT = 256;                  // threads per block
constexpr int WARPS = NT / 32;
constexpr int UNIT_ROWS = WARPS * 16;    // rows a block works on at once
constexpr int WT_STRIDE = WIDTH + 8;     // bf16 elements per row of W^T in shared memory
constexpr int WT_STRIDE32 = WT_STRIDE / 2;
constexpr int KSTEPS = WIDTH / 16;
constexpr int NTILES = WIDTH / 8;
constexpr size_t SMEM_BYTES = (size_t)WIDTH * WT_STRIDE * 2 + (size_t)WARPS * WIDTH * 4;
static_assert(SMEM_BYTES <= 232448, "W^T and the column sums must fit a block's shared memory");

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// bf16(bf16(p) * bf16(0.01)): the product of two bf16 values is exact in f32,
// so it is rounded once.
__device__ __forceinline__ float scale_round(float p, float s) {
  return __bfloat162float(__float2bfloat16_rn(p)) * s;
}

__global__ void __launch_bounds__(NT, 1)
    mma_chain_kernel(const __nv_bfloat16* __restrict__ W, float* __restrict__ partial, int m,
                     int iters, int n_chains, int units, int units_per_step) {
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Wt = reinterpret_cast<__nv_bfloat16*>(smem16);
  const uint32_t* Wt32 = reinterpret_cast<const uint32_t*>(smem16);
  float* colsum = reinterpret_cast<float*>(Wt + WIDTH * WT_STRIDE);  // (WARPS, WIDTH)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int idx = tid; idx < WIDTH * WIDTH; idx += NT) {
    const int k = idx / WIDTH, n = idx % WIDTH;
    Wt[n * WT_STRIDE + k] = W[idx];
  }
  for (int idx = tid; idx < WARPS * WIDTH; idx += NT) colsum[idx] = 0.f;
  __syncthreads();

  const float s = __bfloat162float(__float2bfloat16_rn(0.01f));
  float* my_sum = colsum + warp * WIDTH;
  // The thread's B words of n-tile j, k-step kk: Wt32[b_base + j * 8 * WT_STRIDE32 + kk * 8 (+ 4)].
  const int b_base = g * WT_STRIDE32 + t;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int row0 = (unit % units_per_step) * UNIT_ROWS + warp * 16;
    if (row0 < m) {
      for (int c = 0; c < n_chains; ++c) {
        // h_c: every row is bf16(col * scale). a[kk] is the A fragment of columns
        // 16 kk .. 16 kk + 15: {row g | row g + 8} x {cols 2t, 2t+1 | 2t+8, 2t+9}.
        const float scale = (float)(0.001 * (double)(c + 1));
        uint32_t a[KSTEPS][4];
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int col = 16 * kk + 2 * t;
          a[kk][0] = a[kk][1] = pack_bf16((float)col * scale, (float)(col + 1) * scale);
          a[kk][2] = a[kk][3] = pack_bf16((float)(col + 8) * scale, (float)(col + 9) * scale);
        }
        for (int it = 0; it < iters; ++it) {
          float acc[NTILES][4];
#pragma unroll
          for (int j = 0; j < NTILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
            for (int j = 0; j < NTILES; ++j) {
              const int b = b_base + j * 8 * WT_STRIDE32 + kk * 8;
              mma_m16n8k16(acc[j], a[kk], Wt32[b], Wt32[b + 4]);
            }
          }
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const float(&lo)[4] = acc[2 * kk];
            const float(&hi)[4] = acc[2 * kk + 1];
            a[kk][0] = pack_bf16(scale_round(lo[0], s), scale_round(lo[1], s));
            a[kk][1] = pack_bf16(scale_round(lo[2], s), scale_round(lo[3], s));
            a[kk][2] = pack_bf16(scale_round(hi[0], s), scale_round(hi[1], s));
            a[kk][3] = pack_bf16(scale_round(hi[2], s), scale_round(hi[3], s));
          }
        }
        // This chain's share of the column sums: rows g and g + 8 in the
        // thread, then the eight row groups of the warp by shuffles.
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
              my_sum[col] += v0;
              my_sum[col + 1] += v1;
            }
          }
        }
      }
    }
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      total += colsum[w * WIDTH + tid];
      colsum[w * WIDTH + tid] = 0.f;
    }
    partial[(size_t)unit * WIDTH + tid] = total;
    __syncthreads();
  }
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

// Rows a block works on at once: `partial` holds steps * ceil(m / this) rows of 256 floats.
extern "C" int nerf_probe_mma_unit_rows() { return UNIT_ROWS; }

// w (256, 256) bf16 row-major; out (steps * 8, 256) f32; m a multiple of 16;
// n_blocks: the persistent grid, at most one block per SM. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int nerf_probe_mma(const void* w, float* partial, float* out, int m, int depth,
                              int n_chains, int steps, int n_blocks, void* stream) {
  if (m <= 0 || m % 16 || n_chains <= 0 || steps <= 0 || n_blocks <= 0 || depth < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units_per_step = (m + UNIT_ROWS - 1) / UNIT_ROWS;
  const int units = steps * units_per_step;
  cudaFuncSetAttribute(mma_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  mma_chain_kernel<<<min(n_blocks, units), NT, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(w), partial, m, depth / n_chains, n_chains, units,
      units_per_step);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mma_chain_reduce<<<steps, WIDTH, 0, s>>>(partial, out, units_per_step);
  return (int)cudaGetLastError();
}
