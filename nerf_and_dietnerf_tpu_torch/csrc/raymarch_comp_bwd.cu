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
// What bounds it on an H100: operations: about 4 x 1.024 MFLOP per row (the
// forward for the raw values, then B2's recompute, input-gradient chain and
// weight-gradient products), against 4 + 4 bytes of z and g_w in and 4 of dz
// out per row.
//
// What the design does about that: a block owns whole rays, as the B7
// forward, and keeps their raw values, raw cotangents and compositing dz in
// shared memory (9 floats per row, MAX_S_COMP rows at most). Simple first:
// the raw values are recomputed by a forward pass over the chunks, and B2's
// tile recomputes the forward once more per chunk, instead of keeping every
// chunk's ten activations. Weight gradients are summed as in B2 (per-block
// slabs, fixed-order second launch), so they are bitwise reproducible.
#include "mlp_bwd_tile.cuh"
#include "raymarch_common.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

inline size_t comp_bwd_smem_bytes(int S) {
  return bwd_smem_bytes() + sizeof(float) * 9 * (size_t)rays_per_group(S) * S;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    rm_comp_bwd_kernel(Dims dm, Layout L, Rays ry, const T* __restrict__ W,
                       const T* __restrict__ WT, const float* __restrict__ B,
                       const float* __restrict__ g_rgb, const float* __restrict__ g_w,
                       float* __restrict__ dz, float* __restrict__ partial,
                       T* __restrict__ acts_all, int n_groups) {
  extern __shared__ float4 smem4[];
  const BwdTiles t = bwd_tiles(reinterpret_cast<float*>(smem4));
  const int S = ry.S, rpg = rays_per_group(S);
  float* RAW = t.GI + TM * 8;            // (rpg * S, 4) raw radiance
  float* GRAW = RAW + 4 * rpg * S;        // (rpg * S, 4) its cotangent
  float* DZC = GRAW + 4 * rpg * S;        // (rpg * S) compositing's dz
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  T* acts = acts_all + (size_t)blockIdx.x * NACT * TM * HMAX;
  const int tid = threadIdx.x;

  bool first = true;
  for (int group = blockIdx.x; group < n_groups; group += gridDim.x) {
    const int ray0 = group * rpg;
    const int n_rays = min(rpg, ry.R - ray0);
    const int rows = n_rays * S, grow0 = ray0 * S;
    Dims dl = dm;
    dl.n = rows;
    // 1. the raw radiance of the group's rays
    for (int c0 = 0; c0 < rows; c0 += TM) {
      __syncthreads();
      build_inputs<T>(ry, dm.xyz, dm.dir, grow0 + c0, grow0 + rows, t.X, t.D);
      __syncthreads();
      forward_tile<T>(dl, L, W, B, t.X, t.D, t.P, t.G, t.Ws, nullptr, RAW, c0);
    }
    __syncthreads();
    // 2. the compositing VJP, one thread per ray
    if (tid < n_rays) {
      const size_t ray = (size_t)ray0 + tid;
      composite_ray_bwd(RAW + (size_t)tid * S * 4, ry.z + ray * S, S, g_rgb + ray * 3,
                        g_w + ray * S, GRAW + (size_t)tid * S * 4, DZC + (size_t)tid * S);
    }
    // 3. the MLP backward chunk by chunk, then dz
    for (int c0 = 0; c0 < rows; c0 += TM, first = false) {
      __syncthreads();
      build_inputs<T>(ry, dm.xyz, dm.dir, grow0 + c0, grow0 + rows, t.X, t.D);
      cotangent_tile<T>(t.GI, GRAW, c0, rows);
      __syncthreads();
      backward_tile<T>(dl, L, W, WT, B, t, acts, part, first, c0, nullptr, nullptr);
      if (tid < TM && c0 + tid < rows) {
        const int row = grow0 + c0 + tid;
        dz[row] = DZC[c0 + tid] + dz_of_row(ry, t.GX + tid * XMAX, row);
      }
    }
  }
}

template <typename T>
static int launch(const Dims& dm, const Rays& ry, const void* w, const void* wt, const float* b,
                  const float* g_rgb, const float* g_w, float* dz, float* partial, void* acts,
                  float* dparams, int n_blocks, cudaStream_t stream) {
  if (ry.S <= 0 || ry.S > MAX_S_COMP) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  const int rpg = rays_per_group(ry.S);
  const int groups = (ry.R + rpg - 1) / rpg;
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups) return (int)cudaErrorInvalidValue;
  const size_t smem = comp_bwd_smem_bytes(ry.S);
  cudaFuncSetAttribute(rm_comp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  rm_comp_bwd_kernel<T><<<n_blocks, NT, smem, stream>>>(
      dm, L, ry, static_cast<const T*>(w), static_cast<const T*>(wt), b, g_rgb, g_w, dz, partial,
      static_cast<T*>(acts), groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// g_rgb (R, 3), g_w (R, S) f32 cotangents; dz (R, S) f32 out. Scratch as
// nerf_mlp_bwd's, with 1 <= n_blocks <= nerf_rm_comp_groups(R, S).
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_rm_comp_bwd(int is_bf16, int has_dir, const float* rd, const float* z,
                                const void* w, const void* wt, const float* b,
                                const float* g_rgb, const float* g_w, float* dz, float* partial,
                                void* acts, float* dparams, int n_blocks, int R, int S, int L,
                                int Ld, int D, int xyz, int dir, int hid, int last, float alpha,
                                void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, ry, w, wt, b, g_rgb, g_w, dz, partial, acts,
                                         dparams, n_blocks, s)
                 : launch<float>(dm, ry, w, wt, b, g_rgb, g_w, dz, partial, acts, dparams,
                                 n_blocks, s);
}

// Blocks of rays the compositing kernels walk (whole rays, about 64 rows each).
extern "C" int nerf_rm_comp_groups(int R, int S) {
  if (S <= 0) return 0;
  const int rpg = rays_per_group(S);
  return (R + rpg - 1) / rpg;
}
