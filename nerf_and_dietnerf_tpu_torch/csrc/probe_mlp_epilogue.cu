// P2: B1's forward with the hidden layers' epilogue swapped, to read off how
// much of B1's time is the bias + activation + rounding after each product.
//
// Replaces tools/exp_vpu.py `fwd_pallas` (body `make_fwd`): the view-dir
// network in bf16 with one of three epilogues on the eight trunk layers and
// the rgb hidden layer (the two output heads keep their f32 bias):
//   v1  bf16(p)                                   product and cast only
//   v5  q = bf16(bf16(p) + bf16(b)); max(q, bf16(bf16(alpha) * q))
//                                                 bias and leaky in bf16
//   v3  bf16(max(p + b, alpha * (p + b)))         f32 bias, max-form leaky
// B1 itself (mlp_fwd.cu) is the baseline v0. x and d come in f32 and are
// rounded to bf16 where the tile is loaded, as the TPU body rounds them.
//
// What bounds it on an H100: operations, exactly as B1 (the same products at
// the same shapes; the epilogue is 1 to 4 operations per output element
// against 2 x 256 per element in the product).
//
// What the design does about that: nothing new. The kernel is B1's tile code
// (`forward_tile` in mlp_common.cuh) instantiated with another epilogue
// policy, so any difference in time against B1 is the epilogue's.
#include "mlp_common.cuh"

using namespace nerf_mlp;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct CastOnlyEpilogue {  // v1
  template <typename T>
  static __device__ __forceinline__ float apply(float acc, float, float) {
    return bf16_round(acc);
  }
};

struct Bf16Epilogue {  // v5: every operand and every result a bf16 value
  template <typename T>
  static __device__ __forceinline__ float apply(float acc, float bias, float alpha) {
    const float q = bf16_round(bf16_round(acc) + bf16_round(bias));
    return fmaxf(q, bf16_round(bf16_round(alpha) * q));
  }
};

struct MaxLeakyEpilogue {  // v3
  template <typename T>
  static __device__ __forceinline__ float apply(float acc, float bias, float alpha) {
    const float p = acc + bias;
    return bf16_round(fmaxf(p, alpha * p));
  }
};

template <typename Epi>
__global__ void __launch_bounds__(NT, 1)
    mlp_fwd_variant_kernel(Dims dm, Layout L, const float* __restrict__ x,
                           const float* __restrict__ d, const bf16* __restrict__ W,
                           const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  const int row0 = blockIdx.x * TM;
  load_rows<bf16, float>(X, XMAX, x, dm.xyz, row0, dm.n);
  load_rows<bf16, float>(D, DMAX, d, dm.dir, row0, dm.n);
  __syncthreads();
  forward_tile<bf16, Epi>(dm, L, W, B, X, D, bufA, bufB, Ws, out, row0);
}

template <typename Epi>
static int launch(const Dims& dm, const float* x, const float* d, const bf16* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int tiles = (dm.n + TM - 1) / TM;
  if (tiles == 0) return 0;
  const size_t smem = fwd_smem_bytes();
  cudaFuncSetAttribute(mlp_fwd_variant_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mlp_fwd_variant_kernel<Epi><<<tiles, NT, smem, stream>>>(dm, L, x, d, w, b, out);
  return (int)cudaGetLastError();
}

// variant: 1, 5 or 3. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_mlp_epilogue(int variant, const float* x, const float* d, const void* w,
                                       const float* b, float* out, int n, int xyz, int dir,
                                       int hid, int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, 1, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(w);
  switch (variant) {
    case 1: return launch<CastOnlyEpilogue>(dm, x, d, wb, b, out, s);
    case 5: return launch<Bf16Epilogue>(dm, x, d, wb, b, out, s);
    case 3: return launch<MaxLeakyEpilogue>(dm, x, d, wb, b, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
