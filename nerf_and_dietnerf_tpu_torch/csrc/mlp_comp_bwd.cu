// B4 backward: the VJP of the MLP + compositing forward on given encodings.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py
// `_backward_mlp_comp_pallas` (body `_make_backward_mlp_comp`: `_forward_tile`,
// `_composite_tile_rm`, `_composite_tile_rm_bwd`, `_backward_tile`,
// `_ray_reduce_rm`): for the cotangents of both outputs, g_rgb (R, 3) and g_w
// (R, S), the gradients denc (R * S, xyz) of the xyz encodings, dencd (R, dir)
// of the per-ray view-dir encodings (the per-row gradient summed over each
// ray's S rows), dz (R, S) and the summed weight and bias gradients. dz is
// the compositing's share only (through the sample spacings); the share
// through the points reaches z through denc and the encoding's own backward.
//
// What bounds it on an H100: operations, about 3 x 1.024 MFLOP per row (one
// forward, the input-gradient chain and the weight-gradient products), against
// 66 bytes of bf16 encoding, 4 of z and 4 of g_w in and 132 of denc and 4 of
// dz out per row.
//
// What the design does about that: a block owns whole rays, as the forward,
// and runs ONE forward per row, keeping every tile's ten activations in the
// block's scratch slab and the raw values in shared memory; one thread per
// ray runs the division-free compositing VJP; then the chain walks back tile
// by tile over the kept activations (backward_walk), with the raw cotangents
// read from shared memory. The per-row view-dir gradient is summed per ray in
// row order, tile after tile, by the one thread that owns each (ray, column),
// so dencd, like the weight gradients (per-block slabs, fixed-order second
// launch), is bitwise reproducible without atomics.
// Both types run the ray-group loop of comp_mma_tile.cuh with the policy
// MlpComp below: its inputs as B5's, its compositing VJP as B7's; the walk
// writes the dx rows straight to denc and the dd rows to a per-block BM x dir
// f32 slab (`dds`, plain rows), from which the policy sums dencd.
// - bf16 (every `fuse_compositing` train step of the `pallas` backend): the
//   tensor-core tiles of mlp_mma_tile.cuh (128-row tiles, `mma.sync`), inputs
//   from load_comp_mma_inputs; `w` / `wt` are the F and B packs. Shared
//   memory: comp_mma_tile.cuh's smem_bytes(S), 214,528 bytes at S <= 128.
// - f32 (configs with compute_dtype float32, parity runs): the 3xTF32 tiles
//   of mlp_tf32_mma_tile.cuh (nerf_tmma::Kit, 64-row tiles: at S = 100 and
//   128 a ray spans two, and its dencd sums carry from one to the next),
//   inputs from load_comp_t32_inputs (f32 rows and the exact view-dir
//   encodings, swizzled); `w` / `wt` are the F and B buffers of
//   raymarch_cuda.t32_packs. Shared memory: smem_bytes<nerf_tmma::Kit>(S),
//   201,220 bytes at S = 64.
// Both write the raw values they composited to `raw` where it is given (the
// checks read them).
#include "comp_exports.cuh"
#include "grad_slabs.cuh"
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

// The per-ray work of B4's backward for the ray-group loop, on the encodings
// of the compute type T (bf16 tiles, or the f32 kit's).
template <typename T>
struct MlpComp {
  static constexpr bool INPUT_GRADS = true;  // denc and dencd; dz is DZC alone
  EncRays<T> in;
  Dims dm;
  const float* g_rgb;  // (R, 3)
  const float* g_w;    // (R, S)
  float* denc;         // (R S, xyz)
  float* dencd;        // (R, dir)

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    load_comp_mma_inputs(in, dm, g, r0, X, D);
  }
  __device__ void inputs(const nerf_cmma::Group& g, int r0, float* X, float* D) const {
    load_comp_t32_inputs(in, dm, g, r0, X, D);
  }
  __device__ float composite(const nerf_cmma::Group& g, int i, const float* raw, float* graw,
                             float* dzc) const {
    const size_t ray = (size_t)g.ray0 + i;
    composite_ray_bwd(raw, in.z + ray * in.S, in.S, g_rgb + ray * 3, g_w + ray * in.S, graw, dzc);
    return 0.f;
  }
  __device__ float* dx_rows(const nerf_cmma::Group& g, int r0) const {
    return denc + ((size_t)g.ray0 * in.S + r0) * dm.xyz;
  }
  // Each (ray, column) sum is owned by one thread, which adds the tile's rows
  // of that ray in row order. A ray begun in an earlier tile (S > the kit's
  // BM rows: one ray a group, so thread c owns column c throughout) continues
  // from the thread's carry.
  __device__ void dd_sum(const nerf_cmma::Group& g, int r0, int n, const float* dd,
                         float& carry) const {
    const int S = in.S;
    for (int idx = threadIdx.x; idx < g.n_rays * dm.dir; idx += blockDim.x) {
      const int lr = idx / dm.dir, c = idx - lr * dm.dir;
      const int lo = max(lr * S, r0), hi = min((lr + 1) * S, r0 + n);
      if (lo >= hi) continue;
      float s = lo == lr * S ? 0.f : carry;
      for (int r = lo; r < hi; ++r) s += dd[(r - r0) * dm.dir + c];
      carry = s;
      if (hi == (lr + 1) * S) dencd[(size_t)(g.ray0 + lr) * dm.dir + c] = s;
    }
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    mlp_comp_bwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M,
                            EncRays<nerf_mma::bf16> in, const nerf_mma::bf16* __restrict__ F,
                            const nerf_mma::bf16* __restrict__ Bp, const float* __restrict__ B,
                            const float* __restrict__ g_rgb, const float* __restrict__ g_w,
                            float* __restrict__ denc, float* __restrict__ dencd,
                            float* __restrict__ dz, float* __restrict__ raw,
                            float* __restrict__ partial, nerf_mma::bf16* __restrict__ acts_all,
                            float* __restrict__ dd_all, int groups) {
  extern __shared__ uint4 smem16[];
  const size_t p_total = (size_t)L.total_w + L.total_b;
  const MlpComp<nerf_mma::bf16> pol{in, dm, g_rgb, g_w, denc, dencd};
  nerf_cmma::backward_groups<MlpComp<nerf_mma::bf16>, nerf_cmma::Bf16Kit, nerf_br::Sink>(
      pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
      acts_all + blockIdx.x * nerf_cmma::act_elems(in.S),
      dm.has_dir ? dd_all + (size_t)blockIdx.x * nerf_mma::BM * dm.dir : nullptr, dz, raw, in.R,
      in.S, groups);
}

// f32: the same loop on the 3xTF32 tensor-core tiles.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    mlp_comp_bwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, EncRays<float> in,
                            const float* __restrict__ F, const float* __restrict__ Bp,
                            const float* __restrict__ B, const float* __restrict__ g_rgb,
                            const float* __restrict__ g_w, float* __restrict__ denc,
                            float* __restrict__ dencd, float* __restrict__ dz,
                            float* __restrict__ raw, float* __restrict__ partial,
                            float* __restrict__ acts_all, float* __restrict__ dd_all, int groups) {
  using K = nerf_tmma::Kit;
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const size_t p_total = (size_t)L.total_w + L.total_b;
  const MlpComp<float> pol{in, dm, g_rgb, g_w, denc, dencd};
  nerf_cmma::backward_groups<MlpComp<float>, K, nerf_br::Sink>(
      pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
      acts_all + blockIdx.x * nerf_cmma::act_elems<K>(in.S),
      dm.has_dir ? dd_all + (size_t)blockIdx.x * K::BM * dm.dir : nullptr, dz, raw, in.R, in.S,
      groups);
  T32_END();
}

static int launch(bool bf16, const Dims& dm, const void* enc, const float* encd, const float* z,
                  int R, int S, const void* w, const void* wt, const float* b,
                  const float* g_rgb, const float* g_w, float* denc, float* dencd, float* dz,
                  float* raw, float* partial, void* acts, float* dds, float* dparams,
                  int n_blocks, cudaStream_t stream) {
  const int groups = nerf_comp_groups(bf16, R, S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups || (dm.has_dir && dds == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  cudaError_t err;
  if (bf16) {
    using nerf_mma::bf16;
    const EncRays<bf16> in{static_cast<const bf16*>(enc), encd, z, R, S};
    const size_t smem = nerf_cmma::smem_bytes(S);
    err = cudaFuncSetAttribute(mlp_comp_bwd_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_bwd_mma_kernel<<<n_blocks, nerf_mma::NT, smem, stream>>>(
        dm, L, nerf_mma::make_mma_layout(L), in, static_cast<const bf16*>(w),
        static_cast<const bf16*>(wt), b, g_rgb, g_w, denc, dencd, dz, raw, partial,
        static_cast<bf16*>(acts), dds, groups);
  } else {
    const EncRays<float> in{static_cast<const float*>(enc), encd, z, R, S};
    const size_t smem = nerf_cmma::smem_bytes<nerf_tmma::Kit>(S);
    err = cudaFuncSetAttribute(mlp_comp_bwd_t32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_bwd_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>(
        dm, L, nerf_tmma::make_t32_layout(L), in, static_cast<const float*>(w),
        static_cast<const float*>(wt), b, g_rgb, g_w, denc, dencd, dz, raw, partial,
        static_cast<float*>(acts), dds, groups);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// Inputs as nerf_mlp_comp_fwd's plus the cotangents g_rgb (R, 3) and g_w
// (R, S) f32; denc (R * S, xyz), dencd (R, dir; null without view dirs), dz
// (R, S) and dparams f32 out. Scratch the caller allocates: partial (n_blocks *
// nerf_mlp_param_count) f32, acts (n_blocks * nerf_comp_act_elems(is_bf16,
// S)) elements of the compute type and, with view dirs, dds (n_blocks *
// nerf_comp_dx_rows(is_bf16) * dir) f32, with 1 <= n_blocks <=
// nerf_comp_groups(is_bf16, R, S). w, wt: for bf16 the F and B packs
// (mlp_mma_tile.cuh), for f32 the F and B buffers of mlp_tf32_mma_tile.cuh
// (raymarch_cuda.t32_packs). raw: null, or (R, S, 4) f32 that receives the
// raw values composited.
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_mlp_comp_bwd(int is_bf16, int has_dir, const void* enc, const float* encd,
                                 const float* z, const void* w, const void* wt, const float* b,
                                 const float* g_rgb, const float* g_w, float* denc, float* dencd,
                                 float* dz, float* raw, float* partial, void* acts, float* dds,
                                 float* dparams, int n_blocks, int R, int S, int xyz, int dir,
                                 int hid, int last, float alpha, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  return launch(is_bf16 != 0, dm, enc, encd, z, R, S, w, wt, b, g_rgb, g_w, denc, dencd, dz, raw,
                partial, acts, dds, dparams, n_blocks, static_cast<cudaStream_t>(stream));
}
