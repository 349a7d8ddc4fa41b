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
// shared memory (9 floats per row, MAX_S_COMP rows at most).
// - bf16 (every `pallas_rm` + `fuse_compositing` train step): the ray-group
//   loop of comp_mma_tile.cuh on the tensor-core tiles of mlp_mma_tile.cuh,
//   ONE forward per row (forward_tile keeping the slots and writing RAW, the
//   compositing VJP, backward_walk), X and D built into the bf16 operand
//   tiles by raymarch_tile.cuh as in B6, dx through a per-block BM x xyz
//   slab into dz_of_row; `w` / `wt` are the F and B packs.
// - f32 (parity runs only): the FMA tiles, 64-row chunks; the raw values come
//   from a forward pass over the chunks and B2's tile recomputes the forward
//   once more per chunk; `w` / `wt` the flat weights and their transposes.
// Both write the raw values they composited to `raw` where it is given (the
// checks and tools/comp_f32_steps.py read them).
// Weight gradients are summed as in B2 (per-block slabs, fixed-order second
// launch), so they are bitwise reproducible.
#include "comp_exports.cuh"
#include "mlp_bwd_tile.cuh"
#include "raymarch_common.cuh"
#include "raymarch_tile.cuh"

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
                       float* __restrict__ dz, float* __restrict__ raw, float* __restrict__ partial,
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
    if (raw != nullptr)
      for (int i = tid; i < 4 * rows; i += NT) raw[(size_t)grow0 * 4 + i] = RAW[i];
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

// The bf16 backward's per-ray work for the ray-group loop.
struct RayComp {
  static constexpr bool INPUT_GRADS = false;  // dz takes the points' share
  Rays ry;
  int xyz, dir;
  const float* g_rgb;  // (R, 3)
  const float* g_w;    // (R, S)

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    const int grow0 = g.ray0 * ry.S;
    build_mma_inputs(ry, xyz, dir, grow0 + r0, grow0 + g.rows, X, D);
  }
  __device__ float composite(const nerf_cmma::Group& g, int i, const float* raw, float* graw,
                             float* dzc) const {
    const size_t ray = (size_t)g.ray0 + i;
    composite_ray_bwd(raw, ry.z + ray * ry.S, ry.S, g_rgb + ray * 3, g_w + ray * ry.S, graw, dzc);
    return 0.f;
  }
  __device__ float dz(const nerf_cmma::Group& g, int row, const float* gx,
                      const nerf_mma::bf16*) const {
    return dz_of_row(ry, gx, g.ray0 * ry.S + row);
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the tensor cores.
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
  const RayComp pol{ry, dm.xyz, dm.dir, g_rgb, g_w};
  nerf_cmma::backward_groups(pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
                             acts_all + blockIdx.x * nerf_cmma::act_elems(ry.S),
                             dx_all + (size_t)blockIdx.x * nerf_mma::BM * dm.xyz, dz, raw, ry.R,
                             ry.S, n_groups);
}

// The f32 kernel keeps one 64-row chunk's slots: its tile recomputes the
// forward.
int nerf_comp::f32_chunks_kept(int) { return 1; }

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const void* wt,
                  const float* b, const float* g_rgb, const float* g_w, float* dz, float* raw,
                  float* partial, void* acts, float* dxs, float* dparams, int n_blocks,
                  cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int groups = nerf_comp_groups(bf16, ry.R, ry.S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups || (bf16 && dxs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = launch_kernel(rm_comp_bwd_mma_kernel, n_blocks, nerf_mma::NT,
                        nerf_cmma::smem_bytes(ry.S), stream, dm, L, nerf_mma::make_mma_layout(L),
                        ry, static_cast<const nerf_mma::bf16*>(w),
                        static_cast<const nerf_mma::bf16*>(wt), b, g_rgb, g_w, dz, raw, partial,
                        static_cast<nerf_mma::bf16*>(acts), dxs, groups);
  } else {
    err = launch_kernel(rm_comp_bwd_kernel<float>, n_blocks, NT, comp_bwd_smem_bytes(ry.S),
                        stream, dm, L, ry, static_cast<const float*>(w),
                        static_cast<const float*>(wt), b, g_rgb, g_w, dz, raw, partial,
                        static_cast<float*>(acts), groups);
  }
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// g_rgb (R, 3), g_w (R, S) f32 cotangents; dz (R, S) f32 out. Scratch the
// caller allocates: partial (n_blocks * params) f32, acts (n_blocks *
// nerf_comp_act_elems(is_bf16, S)) of the compute type and, for bf16, dxs
// (n_blocks * nerf_comp_dx_rows(1) * xyz) f32, with 1 <= n_blocks <=
// nerf_comp_groups(is_bf16, R, S). w, wt: for bf16 the F and B packs
// (mlp_mma_tile.cuh), for f32 the flat weights and their transposes. raw:
// null, or (R, S, 4) f32 that receives the raw values composited.
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
