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
// and runs ONE forward per row: the forward pass over the ray's 64-row chunks
// keeps each chunk's ten activations in the block's scratch slab (one set of
// slots per chunk of a group) and the raw values in shared memory; one thread
// per ray runs the division-free compositing VJP; then the chain walks back
// chunk by chunk over the kept activations (backward_walk), with the raw
// cotangents read from shared memory. The per-row view-dir gradient stays on
// chip (in the D tile) and is summed per ray in a fixed order, chunk after
// chunk, so dencd, like the weight gradients (per-block slabs, fixed-order
// second launch), is bitwise reproducible without atomics.
#include "mlp_bwd_tile.cuh"
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

// B2's tiles, 9 floats per row of the group (raw values, their cotangents, the
// compositing's dz) and the per-ray dencd sums.
constexpr size_t comp_bwd_smem_bytes(int S) {
  return bwd_smem_bytes() +
         sizeof(float) * (size_t)rays_per_group(S) * (9 * (size_t)S + DMAX);
}
static_assert(comp_bwd_smem_bytes(MAX_S_COMP) <= 232448, "shared memory of a block");

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    mlp_comp_bwd_kernel(Dims dm, Layout L, EncRays<T> in, const T* __restrict__ W,
                        const T* __restrict__ WT, const float* __restrict__ B,
                        const float* __restrict__ g_rgb, const float* __restrict__ g_w,
                        float* __restrict__ denc, float* __restrict__ dencd,
                        float* __restrict__ dz, float* __restrict__ partial,
                        T* __restrict__ acts_all, int groups) {
  extern __shared__ float4 smem4[];
  BwdTiles t = bwd_tiles(reinterpret_cast<float*>(smem4));
  t.dd_in_D = dm.has_dir;
  const int S = in.S, rpg = rays_per_group(S);
  float* RAW = t.GI + TM * 8;        // (rpg * S, 4) raw radiance
  float* GRAW = RAW + 4 * rpg * S;    // (rpg * S, 4) its cotangent
  float* DZC = GRAW + 4 * rpg * S;    // (rpg * S) compositing's dz
  float* DACC = DZC + rpg * S;        // (rpg, DMAX) per-ray sums of the dd rows
  const size_t p_total = (size_t)L.total_w + L.total_b;
  const size_t slots = (size_t)NACT * TM * HMAX;
  float* part = partial + blockIdx.x * p_total;
  T* acts = acts_all + (size_t)blockIdx.x * chunks_per_group(S) * slots;
  const int tid = threadIdx.x;

  bool first = true;
  for (int group = blockIdx.x; group < groups; group += gridDim.x) {
    const Group g = group_of(group, in.R, S);
    const size_t grow0 = (size_t)g.ray0 * S;
    Dims dl = dm;
    dl.n = g.rows;
    // 1. the forward, once: raw radiance to RAW, activations to the slab
    for (int c0 = 0; c0 < g.rows; c0 += TM) {
      __syncthreads();
      load_chunk<T>(in, dm, g, c0, t.X, t.D);
      __syncthreads();
      forward_tile<T>(dl, L, W, B, t.X, t.D, t.P, t.G, t.Ws, acts + (c0 / TM) * slots, RAW, c0);
    }
    __syncthreads();
    // 2. the compositing VJP, one thread per ray
    if (tid < g.n_rays) {
      const size_t ray = (size_t)g.ray0 + tid;
      composite_ray_bwd(RAW + (size_t)tid * S * 4, in.z + ray * S, S, g_rgb + ray * 3,
                        g_w + ray * S, GRAW + (size_t)tid * S * 4, DZC + (size_t)tid * S);
    }
    __syncthreads();
    for (int idx = tid; idx < g.rows; idx += NT) dz[grow0 + idx] = DZC[idx];
    // 3. the chain back, chunk by chunk
    for (int c0 = 0; c0 < g.rows; c0 += TM, first = false) {
      __syncthreads();
      load_chunk<T>(in, dm, g, c0, t.X, t.D);
      cotangent_tile<T>(t.GI, GRAW, c0, g.rows);
      __syncthreads();
      backward_walk<T>(dl, L, W, WT, B, t, acts + (c0 / TM) * slots, part, first, c0,
                       denc + grow0 * dm.xyz, nullptr);
      if (!dm.has_dir) continue;
      // dencd: each (ray, column) sum is owned by one thread, which adds the
      // chunk's rows of that ray in row order.
      const int c_end = min(c0 + TM, g.rows);
      for (int idx = tid; idx < g.n_rays * dm.dir; idx += NT) {
        const int lr = idx / dm.dir, c = idx % dm.dir;
        const int r_lo = max(lr * S, c0), r_hi = min((lr + 1) * S, c_end);
        if (r_lo >= r_hi) continue;
        float s = r_lo == lr * S ? 0.f : DACC[lr * DMAX + c];
        for (int r = r_lo; r < r_hi; ++r) s += t.D[(r - c0) * DMAX + c];
        DACC[lr * DMAX + c] = s;
        if (r_hi == (lr + 1) * S) dencd[(size_t)(g.ray0 + lr) * dm.dir + c] = s;
      }
    }
  }
}

template <typename T>
static int launch(const Dims& dm, const void* enc, const float* encd, const float* z, int R, int S,
                  const void* w, const void* wt, const float* b, const float* g_rgb,
                  const float* g_w, float* denc, float* dencd, float* dz, float* partial,
                  void* acts, float* dparams, int n_blocks, cudaStream_t stream) {
  const int groups = n_groups(R, S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  const EncRays<T> in{static_cast<const T*>(enc), encd, z, R, S};
  const size_t smem = comp_bwd_smem_bytes(S);
  cudaFuncSetAttribute(mlp_comp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mlp_comp_bwd_kernel<T><<<n_blocks, NT, smem, stream>>>(
      dm, L, in, static_cast<const T*>(w), static_cast<const T*>(wt), b, g_rgb, g_w, denc, dencd,
      dz, partial, static_cast<T*>(acts), groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// Inputs as nerf_mlp_comp_fwd's plus the cotangents g_rgb (R, 3) and g_w
// (R, S) f32; denc (R * S, xyz), dencd (R, dir; null without view dirs), dz
// (R, S) and dparams f32 out. Scratch the caller allocates: partial (n_blocks *
// nerf_mlp_param_count) f32 and acts (n_blocks * nerf_mlp_comp_act_slots(S))
// elements of the compute type, with 1 <= n_blocks <= nerf_mlp_comp_groups(R, S).
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_mlp_comp_bwd(int is_bf16, int has_dir, const void* enc, const float* encd,
                                 const float* z, const void* w, const void* wt, const float* b,
                                 const float* g_rgb, const float* g_w, float* denc, float* dencd,
                                 float* dz, float* partial, void* acts, float* dparams,
                                 int n_blocks, int R, int S, int xyz, int dir, int hid, int last,
                                 float alpha, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, enc, encd, z, R, S, w, wt, b, g_rgb, g_w, denc,
                                         dencd, dz, partial, acts, dparams, n_blocks, s)
                 : launch<float>(dm, enc, encd, z, R, S, w, wt, b, g_rgb, g_w, denc, dencd, dz,
                                 partial, acts, dparams, n_blocks, s);
}
