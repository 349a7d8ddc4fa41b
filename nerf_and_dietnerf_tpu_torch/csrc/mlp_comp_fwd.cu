// B4 forward: the radiance MLP plus alpha compositing on given encodings.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py
// `_forward_mlp_comp_pallas` (body `_make_forward_mlp_comp`: `_ray_expand_rm`,
// `_forward_tile`, `_composite_tile_rm`): from the ray-major xyz encodings
// (R * S, xyz), the per-ray view-dir encodings (R, dir) and z (R, S) to rgb
// (R, 3) and weights (R, S) f32. The raw (R, S, 4) radiance and the per-sample
// copies of the view-dir encoding never reach global memory.
//
// What bounds it on an H100: operations, as B1 (about 1.024 MFLOP per row),
// against 66 bytes of bf16 encoding and 4 of z in and 4 of weights out per
// row. One forward per row.
//
// What the design does about that: compositing needs every sample of a ray,
// so a block owns whole rays (one ray when S >= 64, else 64 / S of them), as
// B7's forward, walks their rows in 64-row chunks through B1's tile, keeps
// their raw values in shared memory, then one thread per ray composites
// serially over its samples. The TPU kernel's one-hot expansion matmuls and
// hi/lo bf16 splits exist for Mosaic only: here a row's ray is row / S.
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

constexpr size_t comp_fwd_smem_bytes(int S) {
  return fwd_smem_bytes() + sizeof(float) * 4 * (size_t)rays_per_group(S) * S;
}
static_assert(comp_fwd_smem_bytes(MAX_S_COMP) <= 232448, "shared memory of a block");

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    mlp_comp_fwd_kernel(Dims dm, Layout L, EncRays<T> in, const T* __restrict__ W,
                        const float* __restrict__ B, float* __restrict__ rgb,
                        float* __restrict__ weights) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  float* RAW = D + TM * DMAX;  // (rays of the group x S, 4)
  const int S = in.S;
  const Group g = group_of(blockIdx.x, in.R, S);
  Dims dl = dm;
  dl.n = g.rows;  // forward_tile writes RAW rows [0, rows)
  for (int c0 = 0; c0 < g.rows; c0 += TM) {
    __syncthreads();
    load_chunk<T>(in, dm, g, c0, X, D);
    __syncthreads();
    forward_tile<T>(dl, L, W, B, X, D, bufA, bufB, Ws, nullptr, RAW, c0);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < g.n_rays) {
    const size_t ray = (size_t)g.ray0 + r;
    composite_ray(RAW + (size_t)r * S * 4, in.z + ray * S, S, rgb + ray * 3, weights + ray * S);
  }
}

template <typename T>
static int launch(const Dims& dm, const void* enc, const float* encd, const float* z, int R, int S,
                  const void* w, const float* b, float* rgb, float* weights,
                  cudaStream_t stream) {
  const int groups = n_groups(R, S);
  if (groups == 0) return R == 0 ? 0 : (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  const EncRays<T> in{static_cast<const T*>(enc), encd, z, R, S};
  const size_t smem = comp_fwd_smem_bytes(S);
  cudaFuncSetAttribute(mlp_comp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mlp_comp_fwd_kernel<T><<<groups, NT, smem, stream>>>(dm, L, in, static_cast<const T*>(w), b,
                                                       rgb, weights);
  return (int)cudaGetLastError();
}

// enc (R * S, xyz) in the compute type, encd (R, dir) f32 (null without view
// dirs), z (R, S) f32; rgb (R, 3) and weights (R, S) f32 out; S <= MAX_S_COMP.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_mlp_comp_fwd(int is_bf16, int has_dir, const void* enc, const float* encd,
                                 const float* z, const void* w, const float* b, float* rgb,
                                 float* weights, int R, int S, int xyz, int dir, int hid, int last,
                                 float alpha, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, enc, encd, z, R, S, w, b, rgb, weights, s)
                 : launch<float>(dm, enc, encd, z, R, S, w, b, rgb, weights, s);
}
