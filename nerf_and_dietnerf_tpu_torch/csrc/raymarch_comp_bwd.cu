// B7 backward: dparams and dz of the fused ray-march + compositing forward.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py
// `_backward_rays_comp_pallas` (body `_make_backward_rays_comp`): for the
// cotangents of both outputs, g_rgb (R, 3) and g_w (R, S) (the coarse
// weights feed the resampler), recompute the rays' raw radiance, run the
// compositing VJP (`_composite_tile_bwd`), then the MLP backward and the
// encoding VJP; dz = the compositing's dz (through the sample spacings) + the
// points' dz. The rays and view components get structural-zero cotangents.
//
// What bounds it on an H100: operations: about 3 x 1.024 MFLOP per row (the
// forward, the input-gradient chain and the weight-gradient products),
// against 4 + 4 bytes of z and g_w in and 4 of dz out per row.
//
// What the design does about that: a block owns whole rays, as the B7
// forward, and keeps their raw values, raw cotangents and compositing dz in
// shared memory (9 floats per row, MAX_S_COMP rows at most), through the
// ray-group loop of comp_mma_tile.cuh: ONE forward per row (forward_tile
// keeping the slots and writing RAW), the compositing VJP one thread per ray,
// then the chain back over the kept slots; X and D built into the operand
// tiles by raymarch_comp_tile.cuh as in B6, dx through a per-block BM x xyz
// slab into dz_of_row.
// - bf16 (every `pallas_rm` + `fuse_compositing` train step): the bf16
//   tensor-core tiles of mlp_mma_tile.cuh (128 rows); `w` / `wt` are the F and
//   B packs.
// - f32 (parity runs only): the 3xTF32 tensor-core tiles of
//   mlp_tf32_mma_tile.cuh (64 rows); `w` / `wt` are the F and B buffers of
//   raymarch_cuda.t32_packs (hi pack | lo pack | flat heads).
// Both write the raw values they composited to `raw` where it is given (the
// checks and tools/comp_f32_steps.py read them).
// Weight gradients are summed as in B2 (per-block slabs, fixed-order second
// launch), so they are bitwise reproducible.
#include "comp_exports.cuh"
#include "grad_slabs.cuh"
#include "raymarch_comp_tile.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

// The backward's per-ray work for the ray-group loop (either kit).
struct RayComp : RayGroupInputs {
  static constexpr bool INPUT_GRADS = false;  // dz takes the points' share
  const float* g_rgb;  // (R, 3)
  const float* g_w;    // (R, S)

  __device__ float composite(const nerf_cmma::Group& g, int i, const float* raw, float* graw,
                             float* dzc) const {
    const size_t ray = (size_t)g.ray0 + i;
    composite_ray_bwd(raw, ry.z + ray * ry.S, ry.S, g_rgb + ray * 3, g_w + ray * ry.S, graw, dzc);
    return 0.f;
  }
  template <typename E>
  __device__ float dz(const nerf_cmma::Group& g, int row, const float* gx, const E*) const {
    return dz_of_row(ry, gx, g.ray0 * ry.S + row);
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the bf16 tensor-core tiles.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    rm_comp_bwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, Rays ry,
                           const nerf_mma::bf16* __restrict__ F,
                           const nerf_mma::bf16* __restrict__ Bp, const float* __restrict__ B,
                           const float* __restrict__ g_rgb, const float* __restrict__ g_w,
                           float* __restrict__ dz, float* __restrict__ raw,
                           float* __restrict__ partial, nerf_mma::bf16* __restrict__ acts_all,
                           float* __restrict__ dx_all, int n_groups) {
  extern __shared__ uint4 smem16[];
  const size_t p_total = (size_t)L.total_w + L.total_b;
  const RayComp pol{{ry, dm.xyz, dm.dir}, g_rgb, g_w};
  nerf_cmma::backward_groups(pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
                             acts_all + blockIdx.x * nerf_cmma::act_elems(ry.S),
                             dx_all + (size_t)blockIdx.x * nerf_mma::BM * dm.xyz, dz, raw, ry.R,
                             ry.S, n_groups);
}

// f32: the same loop on the 3xTF32 tensor-core tiles.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    rm_comp_bwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, Rays ry,
                           const float* __restrict__ F, const float* __restrict__ Bp,
                           const float* __restrict__ B, const float* __restrict__ g_rgb,
                           const float* __restrict__ g_w, float* __restrict__ dz,
                           float* __restrict__ raw, float* __restrict__ partial,
                           float* __restrict__ acts_all, float* __restrict__ dx_all,
                           int n_groups) {
  using K = nerf_tmma::Kit;
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const size_t p_total = (size_t)L.total_w + L.total_b;
  const RayComp pol{{ry, dm.xyz, dm.dir}, g_rgb, g_w};
  nerf_cmma::backward_groups<RayComp, K>(
      pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
      acts_all + blockIdx.x * nerf_cmma::act_elems<K>(ry.S),
      dx_all + (size_t)blockIdx.x * K::BM * dm.xyz, dz, raw, ry.R, ry.S, n_groups);
  T32_END();
}

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const void* wt,
                  const float* b, const float* g_rgb, const float* g_w, float* dz, float* raw,
                  float* partial, void* acts, float* dxs, float* dparams, int n_blocks,
                  cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int groups = nerf_comp_groups(bf16, ry.R, ry.S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups || dxs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = launch_kernel(rm_comp_bwd_mma_kernel, n_blocks, nerf_mma::NT,
                        nerf_cmma::smem_bytes(ry.S), stream, dm, L, nerf_mma::make_mma_layout(L),
                        ry, static_cast<const nerf_mma::bf16*>(w),
                        static_cast<const nerf_mma::bf16*>(wt), b, g_rgb, g_w, dz, raw, partial,
                        static_cast<nerf_mma::bf16*>(acts), dxs, groups);
  } else {
    err = launch_kernel(rm_comp_bwd_t32_kernel, n_blocks, nerf_tmma::NT,
                        nerf_cmma::smem_bytes<nerf_tmma::Kit>(ry.S), stream, dm, L,
                        nerf_tmma::make_t32_layout(L), ry, static_cast<const float*>(w),
                        static_cast<const float*>(wt), b, g_rgb, g_w, dz, raw, partial,
                        static_cast<float*>(acts), dxs, groups);
  }
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// g_rgb (R, 3), g_w (R, S) f32 cotangents; dz (R, S) f32 out. Scratch the
// caller allocates: partial (n_blocks * params) f32, acts (n_blocks *
// nerf_comp_act_elems(is_bf16, S)) of the compute type and dxs (n_blocks *
// nerf_comp_dx_rows(is_bf16) * xyz) f32, with 1 <= n_blocks <=
// nerf_comp_groups(is_bf16, R, S). w, wt: for bf16 the F and B packs
// (mlp_mma_tile.cuh), for f32 the F and B buffers of mlp_tf32_mma_tile.cuh
// (hi pack, lo pack, flat heads). raw: null, or (R, S, 4) f32 that receives
// the raw values composited.
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_rm_comp_bwd(int is_bf16, int has_dir, const float* rd, const float* z,
                                const void* w, const void* wt, const float* b,
                                const float* g_rgb, const float* g_w, float* dz, float* raw,
                                float* partial,
                                void* acts, float* dxs, float* dparams, int n_blocks, int R, int S,
                                int L, int Ld, int D, int xyz, int dir, int hid, int last,
                                float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  return launch(is_bf16 != 0, dm, ry, w, wt, b, g_rgb, g_w, dz, raw, partial, acts, dxs, dparams,
                n_blocks, static_cast<cudaStream_t>(stream));
}
