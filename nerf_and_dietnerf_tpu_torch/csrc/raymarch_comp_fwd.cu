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
// so a block owns whole rays and keeps their raw values in shared memory;
// then one thread per ray composites serially over its samples (S may be any
// count up to MAX_S_COMP, e.g. 192 in an eval render). The TPU kernel's
// one-hot scatter/gather matmuls and lane-roll scans exist for Mosaic only.
// - bf16 (every `pallas_rm` + `fuse_compositing` train step): the forward
//   loop of comp_mma_tile.cuh (forward_groups) on the bf16 tensor-core tiles
//   of mlp_mma_tile.cuh (128-row tiles, `mma.sync`, the F pack), X and D built
//   into the operand tiles as B7's backward builds them (raymarch_comp_tile.cuh
//   RayGroupInputs); one group per block, as B4's forward. The backward runs
//   the same tiles with the same sums, so it composites bitwise the raw values
//   this kernel composited. Shared memory: comp_mma_tile.cuh's
//   fwd_smem_bytes(S), 139,776 bytes at S <= 128.
// - f32 (no train step; the eval renders run B6 and B1): B6's prologue and
//   B1's FMA tile in 64-row chunks, one ray a block when S >= 64, else 64 / S
//   of them; `w` the flat weights.
#include "raymarch_comp_tile.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

inline size_t comp_fwd_smem_bytes(int S) {
  return fwd_smem_bytes() + sizeof(float) * 4 * (size_t)rays_per_group(S) * S;
}

// f32: the FMA tile.
__global__ void __launch_bounds__(NT, 1)
    rm_comp_fwd_kernel(Dims dm, Layout L, Rays ry, const float* __restrict__ W,
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
    build_inputs<float>(ry, dm.xyz, dm.dir, grow0 + c0, grow0 + rows, X, D);
    __syncthreads();
    forward_tile<float>(dl, L, W, B, X, D, bufA, bufB, Ws, RAW, c0);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < n_rays) {
    const size_t ray = (size_t)ray0 + r;
    composite_ray(RAW + (size_t)r * S * 4, ry.z + ray * S, S, rgb + ray * 3, weights + ray * S);
  }
}

// The bf16 kernel's per-ray work for the forward loop.
struct RayCompFwd : RayGroupInputs {
  float* rgb;      // (R, 3)
  float* weights;  // (R, S)

  __device__ void composite(const nerf_cmma::Group& g, int i, const float* raw) const {
    const size_t ray = (size_t)g.ray0 + i;
    composite_ray(raw, ry.z + ray * ry.S, ry.S, rgb + ray * 3, weights + ray * ry.S);
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    rm_comp_fwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, Rays ry,
                           const nerf_mma::bf16* __restrict__ F, const float* __restrict__ B,
                           float* __restrict__ rgb, float* __restrict__ weights,
                           float* __restrict__ raw, int groups) {
  extern __shared__ uint4 smem16[];
  const RayCompFwd pol{{ry, dm.xyz, dm.dir}, rgb, weights};
  nerf_cmma::forward_groups(pol, smem16, dm, L, M, F, B, raw, ry.R, ry.S, groups);
}

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const float* b,
                  float* rgb, float* weights, float* raw, cudaStream_t stream) {
  const int groups = bf16 ? nerf_cmma::n_groups(ry.R, ry.S) : n_groups(ry.R, ry.S);
  if (groups == 0 || (!bf16 && raw != nullptr)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  if (bf16)
    return (int)launch_kernel(rm_comp_fwd_mma_kernel, groups, nerf_mma::NT,
                              nerf_cmma::fwd_smem_bytes(ry.S), stream, dm, L,
                              nerf_mma::make_mma_layout(L), ry,
                              static_cast<const nerf_mma::bf16*>(w), b, rgb, weights, raw, groups);
  return (int)launch_kernel(rm_comp_fwd_kernel, groups, NT, comp_fwd_smem_bytes(ry.S), stream, dm,
                            L, ry, static_cast<const float*>(w), b, rgb, weights);
}

// rgb (R, 3) and weights (R, S) f32 out; 1 <= S <= MAX_S_COMP, R >= 1. w: for
// bf16 the F pack (mlp_mma_tile.cuh), for f32 the flat weights. raw: null, or
// for bf16 (R, S, 4) f32 that receives the raw values composited. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_rm_comp_fwd(int is_bf16, int has_dir, const float* rd, const float* z,
                                const void* w, const float* b, float* rgb, float* weights,
                                float* raw, int R, int S, int L, int Ld, int D, int xyz, int dir,
                                int hid, int last, float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  return launch(is_bf16 != 0, dm, ry, w, b, rgb, weights, raw, static_cast<cudaStream_t>(stream));
}
