// P2: B1's bf16 forward with the hidden layers' epilogue swapped, to read off
// how much of B1's time is the bias + activation after each product.
//
// Replaces tools/exp_vpu.py `fwd_pallas` (body `make_fwd`): the view-dir
// network in bf16 with one of three epilogues on the eight trunk layers and
// the rgb hidden layer (the two output heads keep their f32 bias):
//   v1  bf16(p)                                   product and cast only
//   v5  q = bf16(bf16(p) + bf16(b)); max(q, bf16(bf16(alpha) * q))
//                                                 bias and leaky in bf16
//   v3  bf16(max(p + b, alpha * (p + b)))         f32 bias, max-form leaky
// B1 itself (mlp_fwd.cu) is the baseline v0. x and d come in f32 and are
// rounded to bf16 as the tile is loaded, as the TPU body rounds them.
//
// What bounds it on an H100: operations, as B1: about 1.024 MFLOP a row at
// the flagship widths, 805 GFLOP at the tool's 786,432 rows, at least 0.81 ms
// at 989 TFLOP/s (bf16, dense); the epilogue adds 1 to 4 operations an output
// element against 2 x 256 in its product, and the rows' 244 bytes in and out
// would take 0.06 ms at 3.35 TB/s.
//
// What the design does about that: it is B1. The kernel runs
// nerf_mma::forward_tile (mlp_mma_tile.cuh) on B1's 128-row, 8-warp tile:
// `mma.sync.m16n8k16` products on the F pack streamed through the `cp.async`
// ring, with the variant as the epilogue policy of store_leaky. v3 is B1's
// function (max-form leaky is B1's leaky for 0 < alpha < 1) and runs B1's
// products, so its output is B1's bitwise; whatever else differs from B1 in
// time is the epilogue (and, for all three, the f32 loads of x and d).
//
// Why B1's `mma.sync` tile and not `wgmma`: the probe only means something as
// "B1 with one thing changed". Moving B1 itself onto `wgmma` is its own
// redesign (ROADMAP R2); the probe follows B1 there when B1 moves.
#include "mlp_mma_tile.cuh"

using nerf_mlp::Dims;
using nerf_mlp::Layout;
using namespace nerf_mma;

struct CastOnlyEpilogue {  // v1
  static __device__ __forceinline__ float apply(float acc, float, float) { return acc; }
};

struct Bf16Epilogue {  // v5: every operand and every result a bf16 value
  static __device__ __forceinline__ float apply(float acc, float bias, float alpha) {
    const float q = round_bf(round_bf(acc) + round_bf(bias));
    return fmaxf(q, round_bf(round_bf(alpha) * q));
  }
};

struct MaxLeakyEpilogue {  // v3
  static __device__ __forceinline__ float apply(float acc, float bias, float alpha) {
    const float p = acc + bias;
    return fmaxf(p, alpha * p);
  }
};

template <typename Epi>
__global__ void __launch_bounds__(NT, 1)
    mlp_fwd_variant_kernel(Dims dm, Layout L, MmaLayout M, const float* __restrict__ x,
                           const float* __restrict__ d, const bf16* __restrict__ F,
                           const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ uint4 smem16[];
  const Tiles t = make_tiles(smem16, false);
  Ring ring{t.ring, 0};
  ring_start(ring, fmat(F, M, 0));
  const int row0 = blockIdx.x * BM;
  load_tile(t.X, LDX, x, dm.xyz, row0, dm.n);
  load_tile(t.D, LDD, d, dm.dir, row0, dm.n);
  __syncthreads();
  forward_tile<Epi>(dm, L, M, F, B, t, ring, nullptr, out, row0, nullptr);
}

template <typename Epi>
static int launch(const Dims& dm, const float* x, const float* d, const bf16* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = nerf_mlp::make_layout(dm);
  const size_t smem = fwd_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_variant_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (dm.n + BM - 1) / BM;
  mlp_fwd_variant_kernel<Epi><<<tiles, NT, smem, stream>>>(dm, L, make_mma_layout(L), x, d, w, b,
                                                           out);
  return (int)cudaGetLastError();
}

// variant: 1, 5 or 3; w: the F pack (nerf_mlp_mma_pack_elems elements), as
// B1's. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_mlp_epilogue(int variant, const float* x, const float* d, const void* w,
                                       const float* b, float* out, int n, int xyz, int dir,
                                       int hid, int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, 1, alpha};
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(w);
  switch (variant) {
    case 1: return launch<CastOnlyEpilogue>(dm, x, d, wb, b, out, s);
    case 5: return launch<Bf16Epilogue>(dm, x, d, wb, b, out, s);
    case 3: return launch<MaxLeakyEpilogue>(dm, x, d, wb, b, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
