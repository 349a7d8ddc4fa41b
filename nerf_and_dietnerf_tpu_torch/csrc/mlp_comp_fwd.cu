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
// so a block owns whole rays, keeps their raw values in shared memory, then
// one thread per ray composites serially over its samples. The TPU kernel's
// one-hot expansion matmuls and hi/lo bf16 splits exist for Mosaic only: here
// a row's ray is row / S.
// - bf16 (every `fuse_compositing` train step of the `pallas` backend): the
//   forward loop of comp_mma_tile.cuh (forward_groups) on B1's tensor-core
//   tile (128-row tiles, `mma.sync`, the F pack), its inputs as B5's
//   (load_comp_mma_inputs); one group per block, as B1 launches one tile per
//   block. Its backward runs the same tiles with the same sums, so it
//   composites bitwise the raw values this kernel composited. Shared memory:
//   comp_mma_tile.cuh's fwd_smem_bytes(S), 139,776 bytes at S <= 128.
// - f32 (parity runs only): B1's FMA tile (64-row chunks, one ray a block
//   when S >= 64, else 64 / S of them); `w` the flat weights.
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

constexpr size_t comp_fwd_smem_bytes(int S) {
  return fwd_smem_bytes() + sizeof(float) * 4 * (size_t)rays_per_group(S) * S;
}
static_assert(comp_fwd_smem_bytes(MAX_S_COMP) <= 232448, "shared memory of a block");

// f32: the FMA tile.
__global__ void __launch_bounds__(NT, 1)
    mlp_comp_fwd_kernel(Dims dm, Layout L, EncRays<float> in, const float* __restrict__ W,
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
    load_chunk<float>(in, dm, g, c0, X, D);
    __syncthreads();
    forward_tile<float>(dl, L, W, B, X, D, bufA, bufB, Ws, RAW, c0);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < g.n_rays) {
    const size_t ray = (size_t)g.ray0 + r;
    composite_ray(RAW + (size_t)r * S * 4, in.z + ray * S, S, rgb + ray * 3, weights + ray * S);
  }
}

// The bf16 kernel's per-ray work for the forward loop.
struct MlpCompFwd {
  EncRays<nerf_mma::bf16> in;
  Dims dm;
  float* rgb;      // (R, 3)
  float* weights;  // (R, S)

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    load_comp_mma_inputs(in, dm, g, r0, X, D);
  }
  __device__ void composite(const nerf_cmma::Group& g, int i, const float* raw) const {
    const size_t ray = (size_t)g.ray0 + i;
    composite_ray(raw, in.z + ray * in.S, in.S, rgb + ray * 3, weights + ray * in.S);
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    mlp_comp_fwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M,
                            EncRays<nerf_mma::bf16> in, const nerf_mma::bf16* __restrict__ F,
                            const float* __restrict__ B, float* __restrict__ rgb,
                            float* __restrict__ weights, float* __restrict__ raw, int groups) {
  extern __shared__ uint4 smem16[];
  const MlpCompFwd pol{in, dm, rgb, weights};
  nerf_cmma::forward_groups(pol, smem16, dm, L, M, F, B, raw, in.R, in.S, groups);
}

static int launch(bool bf16, const Dims& dm, const void* enc, const float* encd, const float* z,
                  int R, int S, const void* w, const float* b, float* rgb, float* weights,
                  float* raw, cudaStream_t stream) {
  const int groups = bf16 ? nerf_cmma::n_groups(R, S) : n_groups(R, S);
  if (groups == 0 || (!bf16 && raw != nullptr)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  cudaError_t err;
  if (bf16) {
    using nerf_mma::bf16;
    const EncRays<bf16> in{static_cast<const bf16*>(enc), encd, z, R, S};
    const size_t smem = nerf_cmma::fwd_smem_bytes(S);
    err = cudaFuncSetAttribute(mlp_comp_fwd_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_fwd_mma_kernel<<<groups, nerf_mma::NT, smem, stream>>>(
        dm, L, nerf_mma::make_mma_layout(L), in, static_cast<const bf16*>(w), b, rgb, weights, raw,
        groups);
  } else {
    const EncRays<float> in{static_cast<const float*>(enc), encd, z, R, S};
    const size_t smem = comp_fwd_smem_bytes(S);
    err = cudaFuncSetAttribute(mlp_comp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_fwd_kernel<<<groups, NT, smem, stream>>>(dm, L, in, static_cast<const float*>(w), b,
                                                      rgb, weights);
  }
  return (int)cudaGetLastError();
}

// enc (R * S, xyz) in the compute type, encd (R, dir) f32 (null without view
// dirs), z (R, S) f32; rgb (R, 3) and weights (R, S) f32 out; 1 <= S <=
// MAX_S_COMP, R >= 1. w: for bf16 the F pack (mlp_mma_tile.cuh), for f32 the
// flat weights. raw: null, or for bf16 (R, S, 4) f32 that receives the raw
// values composited. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int nerf_mlp_comp_fwd(int is_bf16, int has_dir, const void* enc, const float* encd,
                                 const float* z, const void* w, const float* b, float* rgb,
                                 float* weights, float* raw, int R, int S, int xyz, int dir,
                                 int hid, int last, float alpha, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  return launch(is_bf16 != 0, dm, enc, encd, z, R, S, w, b, rgb, weights, raw,
                static_cast<cudaStream_t>(stream));
}
