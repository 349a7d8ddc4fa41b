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
// - bf16 (every `fuse_compositing` train step of the `pallas` backend): the
//   ray-group loop of comp_mma_tile.cuh on the tensor-core tiles of
//   mlp_mma_tile.cuh (128-row tiles, `mma.sync`), its inputs as B5's
//   (load_comp_mma_inputs), its compositing VJP as B7's; the walk writes the
//   dx rows straight to denc and the dd rows to a per-block BM x dir f32
//   slab (`dds`), from which the policy sums dencd; `w` / `wt` are the F and B
//   packs. Shared memory: comp_mma_tile.cuh's smem_bytes(S), 214,528 bytes
//   at S <= 128.
// - f32 (parity runs only): the FMA tiles (64-row chunks, the dd rows left in
//   the D tile and summed per ray into DACC); `w` / `wt` the flat weights and
//   their transposes.
#include "comp_exports.cuh"
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

// f32: the FMA tiles.
__global__ void __launch_bounds__(NT, 1)
    mlp_comp_bwd_kernel(Dims dm, Layout L, EncRays<float> in, const float* __restrict__ W,
                        const float* __restrict__ WT, const float* __restrict__ B,
                        const float* __restrict__ g_rgb, const float* __restrict__ g_w,
                        float* __restrict__ denc, float* __restrict__ dencd,
                        float* __restrict__ dz, float* __restrict__ partial,
                        float* __restrict__ acts_all, int groups) {
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
  float* acts = acts_all + (size_t)blockIdx.x * chunks_per_group(S) * slots;
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
      load_chunk<float>(in, dm, g, c0, t.X, t.D);
      __syncthreads();
      forward_tile<float>(dl, L, W, B, t.X, t.D, t.P, t.G, t.Ws, acts + (c0 / TM) * slots, RAW,
                          c0);
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
      load_chunk<float>(in, dm, g, c0, t.X, t.D);
      cotangent_tile<float>(t.GI, GRAW, c0, g.rows);
      __syncthreads();
      backward_walk<float>(dl, L, W, WT, B, t, acts + (c0 / TM) * slots, part, first, c0,
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

// The bf16 kernel's per-ray work for the ray-group loop.
struct MlpComp {
  static constexpr bool INPUT_GRADS = true;  // denc and dencd; dz is DZC alone
  EncRays<nerf_mma::bf16> in;
  Dims dm;
  const float* g_rgb;  // (R, 3)
  const float* g_w;    // (R, S)
  float* denc;         // (R S, xyz)
  float* dencd;        // (R, dir)

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    load_comp_mma_inputs(in, dm, g, r0, X, D);
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
  // of that ray in row order. A ray begun in an earlier tile (S > 128: one
  // ray a group, so thread c owns column c throughout) continues from the
  // thread's carry.
  __device__ void dd_sum(const nerf_cmma::Group& g, int r0, int n, const float* dd,
                         float& carry) const {
    const int S = in.S;
    for (int idx = threadIdx.x; idx < g.n_rays * dm.dir; idx += nerf_mma::NT) {
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
  const MlpComp pol{in, dm, g_rgb, g_w, denc, dencd};
  nerf_cmma::backward_groups(pol, smem16, dm, L, M, F, Bp, B, partial + blockIdx.x * p_total,
                             acts_all + blockIdx.x * nerf_cmma::act_elems(in.S),
                             dm.has_dir ? dd_all + (size_t)blockIdx.x * nerf_mma::BM * dm.dir
                                        : nullptr,
                             dz, raw, in.R, in.S, groups);
}

// The f32 kernel keeps every 64-row chunk of a group (one forward per row).
int nerf_comp::f32_chunks_kept(int S) { return chunks_per_group(S); }
int nerf_comp::f32_slab_rows() { return 0; }

static int launch(bool bf16, const Dims& dm, const void* enc, const float* encd, const float* z,
                  int R, int S, const void* w, const void* wt, const float* b,
                  const float* g_rgb, const float* g_w, float* denc, float* dencd, float* dz,
                  float* raw, float* partial, void* acts, float* dds, float* dparams,
                  int n_blocks, cudaStream_t stream) {
  const int groups = nerf_comp_groups(bf16, R, S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups ||
      (bf16 && dm.has_dir && dds == nullptr) || (!bf16 && raw != nullptr))
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
    const size_t smem = comp_bwd_smem_bytes(S);
    err = cudaFuncSetAttribute(mlp_comp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_comp_bwd_kernel<<<n_blocks, NT, smem, stream>>>(
        dm, L, in, static_cast<const float*>(w), static_cast<const float*>(wt), b, g_rgb, g_w,
        denc, dencd, dz, partial, static_cast<float*>(acts), groups);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// Inputs as nerf_mlp_comp_fwd's plus the cotangents g_rgb (R, 3) and g_w
// (R, S) f32; denc (R * S, xyz), dencd (R, dir; null without view dirs), dz
// (R, S) and dparams f32 out. Scratch the caller allocates: partial (n_blocks *
// nerf_mlp_param_count) f32, acts (n_blocks * nerf_comp_act_elems(is_bf16,
// S)) elements of the compute type and, for bf16 with view dirs, dds
// (n_blocks * nerf_comp_dx_rows(1) * dir) f32, with 1 <= n_blocks <=
// nerf_comp_groups(is_bf16, R, S). w, wt: for bf16 the F and B packs
// (mlp_mma_tile.cuh), for f32 the flat weights and their transposes. raw:
// null, or for bf16 (R, S, 4) f32 that receives the raw values composited.
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
