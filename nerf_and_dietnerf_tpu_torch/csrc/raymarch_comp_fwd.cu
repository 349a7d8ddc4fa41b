// B7 forward: B6 plus alpha compositing, from per-ray data to pixels.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py
// `_forward_rays_comp_pallas` (body `_make_forward_rays_comp`: `_encode_tile`,
// `_forward_tile`, `_composite_tile`): rgb (R, 3) and weights (R, S) f32, the
// raw (R, S, 4) radiance never leaving the chip.
//
// What bounds it on an H100: operations, as B1 and B6 (about 1.024 MFLOP per
// row); device memory sees 4 bytes of z per row and 4 of weights out.
//
// What the design does about that: compositing needs every sample of a ray,
// so a block owns whole rays (one ray when S >= 64, else 64 / S of them) and
// walks their rows in 64-row chunks through B6's prologue and B1's tile,
// keeping the raw values of its rays in shared memory; then one thread per
// ray composites serially over its samples (S may be any count up to
// MAX_S_COMP, e.g. 192 in an eval render). The TPU kernel's one-hot
// scatter/gather matmuls and lane-roll scans exist for Mosaic only.
#include "raymarch_common.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

inline size_t comp_fwd_smem_bytes(int S) {
  return fwd_smem_bytes() + sizeof(float) * 4 * (size_t)rays_per_group(S) * S;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    rm_comp_fwd_kernel(Dims dm, Layout L, Rays ry, const T* __restrict__ W,
                       const float* __restrict__ B, float* __restrict__ rgb,
                       float* __restrict__ weights) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  float* RAW = D + TM * DMAX;  // (rays of the group x S, 4)
  const int S = ry.S, rpg = rays_per_group(S);
  const int ray0 = blockIdx.x * rpg;
  const int n_rays = min(rpg, ry.R - ray0);
  const int rows = n_rays * S, grow0 = ray0 * S;
  Dims dl = dm;
  dl.n = rows;  // forward_tile writes RAW rows [0, rows)
  for (int c0 = 0; c0 < rows; c0 += TM) {
    __syncthreads();
    build_inputs<T>(ry, dm.xyz, dm.dir, grow0 + c0, grow0 + rows, X, D);
    __syncthreads();
    forward_tile<T>(dl, L, W, B, X, D, bufA, bufB, Ws, nullptr, RAW, c0);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < n_rays) {
    const size_t ray = (size_t)ray0 + r;
    composite_ray(RAW + (size_t)r * S * 4, ry.z + ray * S, S, rgb + ray * 3, weights + ray * S);
  }
}

template <typename T>
static int launch(const Dims& dm, const Rays& ry, const void* w, const float* b, float* rgb,
                  float* weights, cudaStream_t stream) {
  if (ry.S <= 0 || ry.S > MAX_S_COMP) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  const int rpg = rays_per_group(ry.S);
  const int groups = (ry.R + rpg - 1) / rpg;
  if (groups == 0) return 0;
  const size_t smem = comp_fwd_smem_bytes(ry.S);
  cudaFuncSetAttribute(rm_comp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  rm_comp_fwd_kernel<T><<<groups, NT, smem, stream>>>(dm, L, ry, static_cast<const T*>(w), b,
                                                      rgb, weights);
  return (int)cudaGetLastError();
}

// rgb (R, 3) and weights (R, S) f32 out; S <= MAX_S_COMP.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_rm_comp_fwd(int is_bf16, int has_dir, const float* rd, const float* z,
                                const void* w, const float* b, float* rgb, float* weights, int R,
                                int S, int L, int Ld, int D, int xyz, int dir, int hid, int last,
                                float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, ry, w, b, rgb, weights, s)
                 : launch<float>(dm, ry, w, b, rgb, weights, s);
}
