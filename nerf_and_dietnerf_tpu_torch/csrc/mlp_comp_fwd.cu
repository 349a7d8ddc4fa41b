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
// a row's ray is row / S. Both types run the forward loop of comp_mma_tile.cuh
// (forward_groups) with the policy MlpCompFwd below, its inputs as B5's and
// B4's backward's; the backward runs the same tiles with the same sums, so it
// composites bitwise the raw values this kernel composited.
// - bf16 (every `fuse_compositing` train step of the `pallas` backend): B1's
//   tensor-core tile (128-row tiles, `mma.sync`, the F pack), inputs from
//   load_comp_mma_inputs; one group per block, as B1 launches one tile per
//   block. Shared memory: comp_mma_tile.cuh's fwd_smem_bytes(S), 139,776
//   bytes at S <= 128.
// - f32 (the same steps of a compute_dtype float32 config, parity runs): the
//   3xTF32 tensor-core tiles of mlp_tf32_mma_tile.cuh (nerf_tmma::Kit, 64-row
//   tiles: a ray spans two at S = 128), inputs from load_comp_t32_inputs (f32
//   rows and the exact view-dir encodings, swizzled), reading the F buffer of
//   raymarch_cuda.t32_packs; one group per block. Shared memory:
//   fwd_smem_bytes<nerf_tmma::Kit>(S), 130,304 bytes at S <= 64.
// Both write the raw values they composited to `raw` where it is given (the
// checks read them).
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

// The per-ray work of the forward loop, on the encodings of the compute type
// T (bf16 tiles, or the f32 kit's).
template <typename T>
struct MlpCompFwd {
  EncRays<T> in;
  Dims dm;
  float* rgb;      // (R, 3)
  float* weights;  // (R, S)

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    load_comp_mma_inputs(in, dm, g, r0, X, D);
  }
  __device__ void inputs(const nerf_cmma::Group& g, int r0, float* X, float* D) const {
    load_comp_t32_inputs(in, dm, g, r0, X, D);
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
  const MlpCompFwd<nerf_mma::bf16> pol{in, dm, rgb, weights};
  nerf_cmma::forward_groups(pol, smem16, dm, L, M, F, B, raw, in.R, in.S, groups);
}

// f32: the same loop on the 3xTF32 tensor-core tiles.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    mlp_comp_fwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, EncRays<float> in,
                            const float* __restrict__ F, const float* __restrict__ B,
                            float* __restrict__ rgb, float* __restrict__ weights,
                            float* __restrict__ raw, int groups) {
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const MlpCompFwd<float> pol{in, dm, rgb, weights};
  nerf_cmma::forward_groups<MlpCompFwd<float>, nerf_tmma::Kit>(pol, smem16, dm, L, M, F, B, raw,
                                                               in.R, in.S, groups);
  T32_END();
}

static int launch(bool bf16, const Dims& dm, const void* enc, const float* encd, const float* z,
                  int R, int S, const void* w, const float* b, float* rgb, float* weights,
                  float* raw, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int groups = bf16 ? nerf_cmma::n_groups(R, S) : nerf_cmma::n_groups(R, S, nerf_tmma::BM);
  if (groups == 0) return (int)cudaErrorInvalidValue;
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
    const size_t smem = nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(S);
    err = cudaFuncSetAttribute(mlp_comp_fwd_t32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_fwd_t32_kernel<<<groups, nerf_tmma::NT, smem, stream>>>(
        dm, L, nerf_tmma::make_t32_layout(L), in, static_cast<const float*>(w), b, rgb, weights,
        raw, groups);
  }
  return (int)cudaGetLastError();
}

// enc (R * S, xyz) in the compute type, encd (R, dir) f32 (null without view
// dirs), z (R, S) f32; rgb (R, 3) and weights (R, S) f32 out; 1 <= S <=
// MAX_S_COMP, R >= 1. w: for bf16 the F pack (mlp_mma_tile.cuh), for f32 the
// F buffer of mlp_tf32_mma_tile.cuh (raymarch_cuda.t32_packs). raw: null, or
// (R, S, 4) f32 that receives the raw values composited. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_mlp_comp_fwd(int is_bf16, int has_dir, const void* enc, const float* encd,
                                 const float* z, const void* w, const float* b, float* rgb,
                                 float* weights, float* raw, int R, int S, int xyz, int dir,
                                 int hid, int last, float alpha, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  return launch(is_bf16 != 0, dm, enc, encd, z, R, S, w, b, rgb, weights, raw,
                static_cast<cudaStream_t>(stream));
}
