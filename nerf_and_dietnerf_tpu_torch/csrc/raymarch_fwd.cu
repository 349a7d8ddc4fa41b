// B6 forward: points, both encodings and the radiance MLP from per-ray data.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py `_forward_rays_pallas`
// (body `_make_forward_rays`: `_encode_tile` then `_forward_tile`): from rays
// (R, 6 + D) f32 and z (R, S) f32, each row's point o + z d, its xyz and view
// encodings rounded to the compute type, then B1's network; (R, S, 4) f32 out.
//
// What bounds it on an H100: operations, as B1 (about 1.024 MFLOP per row at
// the flagship widths), now against only 4 bytes of z and 36 / S bytes of ray
// data in per row (the (N, 33) + (N, 24) encodings B1 reads are never in
// device memory) and 16 bytes out.
//
// What the design does about that: each block builds its 64-row tile's
// encodings straight into the shared-memory input tile (one thread per
// (row, column), the sin of a column computed by the thread that stores it),
// then runs B1's tile (mlp_common.cuh). The TPU kernel's sample-major row
// layout, one-hot expansion matmuls and weight-row permutation exist for
// Mosaic only and are not carried over: rows stay ray-major and the features
// keep the reference's column order.
#include "raymarch_common.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    rm_fwd_kernel(Dims dm, Layout L, Rays ry, const T* __restrict__ W,
                  const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  const int row0 = blockIdx.x * TM;
  build_inputs<T>(ry, dm.xyz, dm.dir, row0, dm.n, X, D);
  __syncthreads();
  forward_tile<T>(dm, L, W, B, X, D, bufA, bufB, Ws, nullptr, out, row0);
}

template <typename T>
static int launch(const Dims& dm, const Rays& ry, const void* w, const float* b, float* out,
                  cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int tiles = (dm.n + TM - 1) / TM;
  if (tiles == 0) return 0;
  const size_t smem = fwd_smem_bytes();
  cudaFuncSetAttribute(rm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rm_fwd_kernel<T><<<tiles, NT, smem, stream>>>(dm, L, ry, static_cast<const T*>(w), b, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_rm_fwd(int is_bf16, int has_dir, const float* rd, const float* z,
                           const void* w, const float* b, float* out, int R, int S, int L, int Ld,
                           int D, int xyz, int dir, int hid, int last, float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, ry, w, b, out, s) : launch<float>(dm, ry, w, b, out, s);
}
