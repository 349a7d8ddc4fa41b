// B1: forward of the radiance MLP, one row tile per thread block.
//
// Replaces nerf_and_dietnerf_tpu/ops/raymarch_pallas.py `_forward_pallas`
// (body `_forward_tile`): 8 leaky trunk layers with the skip as
// x @ W4a + h @ W4b, then the view-dir heads ((h8 | d) -> last -> 3 and sigma
// from (h8 | d)) or the xyz-only heads (256 -> 256 -> last -> 3, sigma from
// h8); bf16 or f32 operands, f32 sums, activations rounded to the compute
// type after each leaky, (n, 4) f32 out.
//
// What bounds it on an H100: operations. About 1.024 MFLOP per row at the
// flagship widths (33 -> 8 x 256 -> 280 -> 128 -> 3), against 16 + 48 input
// bytes and 16 output bytes per row, so it is far above the card's
// operations-per-byte line in either type.
//
// What the design does about that: no activation leaves the chip. A block
// keeps its 64-row tile's activations in shared memory for the whole network
// and streams each layer's weights through a 32 x 256 shared chunk (the whole
// net is about 1 MB in bf16, 2 MB in f32, more than a block's 227 KB; the
// weights stay hot in L2 across blocks). Each thread keeps an 8 x 8 register
// tile of the layer output, so every shared-memory read feeds 8 FMAs. The
// products are plain f32 FMAs (true f32 on the eval path, exact products of
// bf16 values on the train path): simple and right first; tensor-core
// (wgmma) tiles are the step that makes it fast.
#include "mlp_common.cuh"

using namespace nerf_mlp;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    mlp_fwd_kernel(Dims dm, Layout L, const T* __restrict__ x, const T* __restrict__ d,
                   const T* __restrict__ W, const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  const int row0 = blockIdx.x * TM;
  load_rows<T>(X, XMAX, x, dm.xyz, row0, dm.n);
  if (dm.has_dir) load_rows<T>(D, DMAX, d, dm.dir, row0, dm.n);
  __syncthreads();
  forward_tile<T>(dm, L, W, B, X, D, bufA, bufB, Ws, nullptr, out, row0);
}

template <typename T>
static int launch(const Dims& dm, const void* x, const void* d, const void* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int tiles = (dm.n + TM - 1) / TM;
  if (tiles == 0) return 0;
  const size_t smem = fwd_smem_bytes();
  cudaFuncSetAttribute(mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  mlp_fwd_kernel<T><<<tiles, NT, smem, stream>>>(dm, L, static_cast<const T*>(x),
                                                 static_cast<const T*>(d),
                                                 static_cast<const T*>(w), b, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_mlp_fwd(int is_bf16, int has_dir, const void* x, const void* d,
                            const void* w, const float* b, float* out, int n, int xyz, int dir,
                            int hid, int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, has_dir, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, x, d, w, b, out, s)
                 : launch<float>(dm, x, d, w, b, out, s);
}
