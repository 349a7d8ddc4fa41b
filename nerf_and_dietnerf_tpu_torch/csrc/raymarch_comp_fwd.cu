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
// Both types run the forward loop of comp_mma_tile.cuh (forward_groups) with
// the policy RayCompFwd below, X and D built into the operand tiles as B7's
// backward builds them (raymarch_comp_tile.cuh RayGroupInputs); the backward
// runs the same tiles with the same sums, so it composites bitwise the raw
// values this kernel composited.
// - bf16 (every `pallas_rm` + `fuse_compositing` train step): the bf16
//   tensor-core tiles of mlp_mma_tile.cuh (128-row tiles, `mma.sync`, the F
//   pack), one group per block. Shared memory: comp_mma_tile.cuh's
//   fwd_smem_bytes(S), 139,776 bytes at S <= 128.
// - f32 (the same steps of a compute_dtype float32 config): the 3xTF32
//   tensor-core tiles of mlp_tf32_mma_tile.cuh (nerf_tmma::Kit, 64-row tiles:
//   a ray spans two at S = 128, three at S = 192), reading the F buffer of
//   raymarch_cuda.t32_packs; one group per block. Shared memory:
//   fwd_smem_bytes<nerf_tmma::Kit>(S), 130,304 bytes at S <= 64.
// Both write the raw values they composited to `raw` where it is given (the
// checks read them).
#include "raymarch_comp_tile.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

// The per-ray work of the forward loop (either kit).
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

// f32: the same loop on the 3xTF32 tensor-core tiles.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    rm_comp_fwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, Rays ry,
                           const float* __restrict__ F, const float* __restrict__ B,
                           float* __restrict__ rgb, float* __restrict__ weights,
                           float* __restrict__ raw, int groups) {
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const RayCompFwd pol{{ry, dm.xyz, dm.dir}, rgb, weights};
  nerf_cmma::forward_groups<RayCompFwd, nerf_tmma::Kit>(pol, smem16, dm, L, M, F, B, raw, ry.R,
                                                        ry.S, groups);
  T32_END();
}

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const float* b,
                  float* rgb, float* weights, float* raw, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  if (bf16) {
    const int groups = nerf_cmma::n_groups(ry.R, ry.S);
    if (groups == 0) return (int)cudaErrorInvalidValue;
    return (int)launch_kernel(rm_comp_fwd_mma_kernel, groups, nerf_mma::NT,
                              nerf_cmma::fwd_smem_bytes(ry.S), stream, dm, L,
                              nerf_mma::make_mma_layout(L), ry,
                              static_cast<const nerf_mma::bf16*>(w), b, rgb, weights, raw, groups);
  }
  const int groups = nerf_cmma::n_groups(ry.R, ry.S, nerf_tmma::BM);
  if (groups == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_kernel(rm_comp_fwd_t32_kernel, groups, nerf_tmma::NT,
                            nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(ry.S), stream, dm, L,
                            nerf_tmma::make_t32_layout(L), ry, static_cast<const float*>(w), b,
                            rgb, weights, raw, groups);
}

// rgb (R, 3) and weights (R, S) f32 out; 1 <= S <= MAX_S_COMP, R >= 1. w: for
// bf16 the F pack (mlp_mma_tile.cuh), for f32 the F buffer of
// mlp_tf32_mma_tile.cuh (raymarch_cuda.t32_packs). raw: null, or (R, S, 4)
// f32 that receives the raw values composited. Returns cudaGetLastError()
// after the launch (0 on success).
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
