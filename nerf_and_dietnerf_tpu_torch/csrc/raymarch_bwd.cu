// B6 backward: dparams and dz of the fused ray-march forward.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py `_backward_rays_pallas`
// (body `_make_backward_rays`): rebuild the tile's points and encodings from
// the rays and z, run B2's recompute-in-tile backward, then the encoding VJP
// down to dz (R, S), the only live input cotangent (it carries the
// fine-resampling gradient back into the coarse network). The rays and view
// components get structural-zero cotangents there, so the view-dir gradient is
// not formed at all.
//
// What bounds it on an H100: operations, as B2 (about 3 x 1.024 MFLOP per
// row), against 16 bytes of cotangent and 4 of z in and 4 of dz out per row.
//
// What the design does about that: B2's tile (mlp_bwd_tile.cuh) on inputs
// built on chip; the tile's dx stays in shared memory and one thread per row
// turns it into dz (dtheta = dx * cos(theta), dpts = sum f_k dtheta + dx_id,
// dz = dpts . d). Weight gradients are summed as in B2: each block walks a
// fixed, strided set of tiles into its own slab, and a second launch adds the
// slabs in block order, so two runs give bitwise-equal gradients.
#include "mlp_bwd_tile.cuh"
#include "raymarch_common.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    rm_bwd_kernel(Dims dm, Layout L, Rays ry, const T* __restrict__ W, const T* __restrict__ WT,
                  const float* __restrict__ B, const float* __restrict__ g,
                  float* __restrict__ dz, float* __restrict__ partial, T* __restrict__ acts_all,
                  int n_tiles) {
  extern __shared__ float4 smem4[];
  const BwdTiles t = bwd_tiles(reinterpret_cast<float*>(smem4));
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  T* acts = acts_all + (size_t)blockIdx.x * NACT * TM * HMAX;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * TM;
    __syncthreads();
    build_inputs<T>(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);
    load_cotangent<T>(t.GI, g, row0, dm.n);
    __syncthreads();
    backward_tile<T>(dm, L, W, WT, B, t, acts, part, first, row0, nullptr, nullptr);
    const int r = threadIdx.x;
    if (r < TM && row0 + r < dm.n) dz[row0 + r] = dz_of_row(ry, t.GX + r * XMAX, row0 + r);
  }
}

template <typename T>
static int launch(const Dims& dm, const Rays& ry, const void* w, const void* wt, const float* b,
                  const float* g, float* dz, float* partial, void* acts, float* dparams,
                  int n_blocks, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int tiles = (dm.n + TM - 1) / TM;
  if (tiles == 0 || n_blocks <= 0 || n_blocks > tiles) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes();
  cudaFuncSetAttribute(rm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rm_bwd_kernel<T><<<n_blocks, NT, smem, stream>>>(
      dm, L, ry, static_cast<const T*>(w), static_cast<const T*>(wt), b, g, dz, partial,
      static_cast<T*>(acts), tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// g: (R, S, 4) f32 cotangent of the raw output; dz: (R, S) f32. Scratch as
// nerf_mlp_bwd's: partial (n_blocks * params) f32 and acts
// (n_blocks * NACT * TM * HMAX) of the compute type, 1 <= n_blocks <= tiles.
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_rm_bwd(int is_bf16, int has_dir, const float* rd, const float* z,
                           const void* w, const void* wt, const float* b, const float* g,
                           float* dz, float* partial, void* acts, float* dparams, int n_blocks,
                           int R, int S, int L, int Ld, int D, int xyz, int dir, int hid, int last,
                           float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, ry, w, wt, b, g, dz, partial, acts, dparams,
                                         n_blocks, s)
                 : launch<float>(dm, ry, w, wt, b, g, dz, partial, acts, dparams, n_blocks, s);
}
