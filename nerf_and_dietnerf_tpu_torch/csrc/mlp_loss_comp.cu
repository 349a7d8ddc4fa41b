// B5: the fine-pass objective in one kernel: forward, compositing, the mean
// squared error against the target pixels, and the whole backward.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py
// `_loss_mlp_comp_pallas` (body `_make_loss_mlp_comp`, encoding VJP constants
// `_enc_vjp_consts`): per ray, the MLP forward with its activations kept, the
// composited pixel, err = pixel - target, the loss share sum(err^2) * inv_n
// (inv_n = 1 / (3 R)), the pixel cotangent 2 inv_n err (weights cotangent
// zero), the compositing VJP, the MLP backward over the kept activations, and
// the xyz-encoding VJP from the encoding's own neighbouring columns, down to
// z. Out: the scalar loss, the TOTAL dz (R, S) = the compositing's share (the
// sample spacings) + the points' share, and the summed weight and bias
// gradients. The encodings, directions and targets get no gradient.
//
// The encoding VJP needs no trigonometry: per coordinate the columns are
// [c, sin f0 c, cos f0 c, sin f1 c, ...] (core/encoding.py), f_k = pi 2^k, so
// d(column j)/dc is 1 for the identity column, f_k times the column to its
// right for a sin column and -f_k times the column to its left for a cos
// column, whatever computed the values. The columns are read as the kernel
// got them (in bf16: rounded, widened to f32), as on the TPU. Then
// dz = sum_c (sum_j g_j d_j) dvec_c, with dvec the ray's unnormalised
// direction.
//
// What bounds it on an H100: operations, about 3 x 1.024 MFLOP per row,
// against 66 bytes of bf16 encoding and 4 of z in and 4 of dz out per row.
//
// What the design does about that: ONE forward per row and no recompute, the
// kernel's defining property: whole rays per block, every tile's ten
// activations kept in the block's scratch slab, raw values and cotangents in
// shared memory, the chain back over the kept activations, with the
// cotangent made in the kernel.
// - bf16 (every `fuse_fine_loss` train step): the ray-group loop of
//   comp_mma_tile.cuh on the tensor-core tiles of mlp_mma_tile.cuh (128-row
//   tiles, `mma.sync`): X copied from the bf16 encodings, D each ray's f32
//   view-dir encoding rounded to bf16 into every row (load_comp_mma_inputs),
//   dx through a per-block BM x xyz slab into dz_points, which reads the X
//   tile's bf16 values widened to f32; `w` / `wt` are the F and B packs.
// - f32 (parity runs, configs with compute_dtype float32): the same loop on
//   the 3xTF32 tensor-core tiles of mlp_tf32_mma_tile.cuh (64-row tiles; at S
//   = 128 a group is one ray over two tiles, both tiles' slots kept): X the
//   f32 encodings, D each ray's f32 view-dir encoding copied exactly, both
//   stored swizzled (load_comp_t32_inputs), so dz_points reads the X row
//   through nerf_tmma::sw; `w` / `wt` are the F and B buffers of
//   raymarch_cuda.t32_packs.
// On the TPU the loss is summed across sequential grid steps; blocks here run
// in no order, so a block's loss share is the last entry of its gradient
// slab, and the second launch adds the slabs in block order: the loss and the
// gradients are bitwise reproducible.
#include "comp_exports.cuh"
#include "grad_slabs.cuh"
#include "mlp_comp_common.cuh"

using namespace nerf_mlp;
using namespace nerf_comp;

constexpr float PI_F = 3.14159265358979f;

// Where column c of a tile row is stored: bf16 tiles plainly, the f32 tiles
// of mlp_tf32_mma_tile.cuh swizzled (nerf_tmma::sw of the row in its tile).
struct PlainCols {
  __device__ int operator()(int c) const { return c; }
};
struct SwizzledCols {
  int r;  // the row in its tile
  __device__ int operator()(int c) const { return nerf_tmma::sw(r, c); }
};

// The points' share of one row's dz: its xyz-encoding cotangent gx and its
// encoding row x (of the dx slab and the X tile; X f32 or bf16, read widened,
// column c at x[col(c)]) through the encoding VJP, then the ray's direction.
template <typename X, typename Col>
__device__ inline float dz_points(const float* gx, const X* x, int n_freq, const float* dvec,
                                  Col col) {
  const int per = 1 + 2 * n_freq;
  float dz = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float* g = gx + c * per;
    const int e = c * per;
    float s = g[0];
    for (int k = 0; k < n_freq; ++k) {
      const float f = ldexpf(PI_F, k);
      s += g[1 + 2 * k] * (f * to_f<X>(x[col(e + 2 + 2 * k)]));
      s += g[2 + 2 * k] * (-f * to_f<X>(x[col(e + 1 + 2 * k)]));
    }
    dz += s * dvec[c];
  }
  return dz;
}

// The per-ray work of B5 for the ray-group loop, on the encodings of the
// compute type T (bf16 tiles, or the f32 kit's).
template <typename T>
struct LossComp {
  static constexpr bool INPUT_GRADS = false;  // dz takes the points' share
  EncRays<T> in;
  Dims dm;
  const float* dvec;    // (R, 3)
  const float* target;  // (R, 3)
  float inv_n;

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    load_comp_mma_inputs(in, dm, g, r0, X, D);
  }
  __device__ void inputs(const nerf_cmma::Group& g, int r0, float* X, float* D) const {
    load_comp_t32_inputs(in, dm, g, r0, X, D);
  }
  // Pixel, error, its cotangent 2 inv_n err and the compositing VJP; returns
  // the ray's squared error.
  __device__ float composite(const nerf_cmma::Group& g, int i, const float* raw, float* graw,
                             float* dzc) const {
    const size_t ray = (size_t)g.ray0 + i;
    const float* z = in.z + ray * in.S;
    float pixel[3], g_pix[3], e2 = 0.f;
    composite_ray(raw, z, in.S, pixel, dzc);
    for (int ch = 0; ch < 3; ++ch) {
      const float err = pixel[ch] - target[ray * 3 + ch];
      e2 += err * err;
      g_pix[ch] = (2.f * inv_n) * err;
    }
    composite_ray_bwd(raw, z, in.S, g_pix, nullptr, graw, dzc);
    return e2;
  }
  // x: the row of the X tile, bf16 plain or f32 swizzled (row `row` of the
  // group is row row % BM of its tile).
  __device__ float dz(const nerf_cmma::Group& g, int row, const float* gx,
                      const nerf_mma::bf16* x) const {
    return dz_points(gx, x, (dm.xyz - 3) / 6, dvec + (size_t)(g.ray0 + row / in.S) * 3,
                     PlainCols{});
  }
  __device__ float dz(const nerf_cmma::Group& g, int row, const float* gx, const float* x) const {
    return dz_points(gx, x, (dm.xyz - 3) / 6, dvec + (size_t)(g.ray0 + row / in.S) * 3,
                     SwizzledCols{row % nerf_tmma::BM});
  }
};

// bf16: the ray groups of comp_mma_tile.cuh on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    mlp_loss_comp_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M,
                             EncRays<nerf_mma::bf16> in, const float* __restrict__ dvec,
                             const float* __restrict__ target, float inv_n,
                             const nerf_mma::bf16* __restrict__ F,
                             const nerf_mma::bf16* __restrict__ Bp, const float* __restrict__ B,
                             float* __restrict__ dz, float* __restrict__ raw,
                             float* __restrict__ partial, nerf_mma::bf16* __restrict__ acts_all,
                             float* __restrict__ dx_all, int groups) {
  extern __shared__ uint4 smem16[];
  // The block's slab: weight gradients, bias gradients, its share of the loss.
  const size_t p_total = (size_t)L.total_w + L.total_b + 1;
  float* part = partial + blockIdx.x * p_total;
  const LossComp<nerf_mma::bf16> pol{in, dm, dvec, target, inv_n};
  const float sq_err = nerf_cmma::backward_groups(
      pol, smem16, dm, L, M, F, Bp, B, part, acts_all + blockIdx.x * nerf_cmma::act_elems(in.S),
      dx_all + (size_t)blockIdx.x * nerf_mma::BM * dm.xyz, dz, raw, in.R, in.S, groups);
  if (threadIdx.x == 0) part[p_total - 1] = sq_err * inv_n;
}

// f32: the same loop on the 3xTF32 tensor-core tiles.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    mlp_loss_comp_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, EncRays<float> in,
                             const float* __restrict__ dvec, const float* __restrict__ target,
                             float inv_n, const float* __restrict__ F,
                             const float* __restrict__ Bp, const float* __restrict__ B,
                             float* __restrict__ dz, float* __restrict__ raw,
                             float* __restrict__ partial, float* __restrict__ acts_all,
                             float* __restrict__ dx_all, int groups) {
  using K = nerf_tmma::Kit;
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const size_t p_total = (size_t)L.total_w + L.total_b + 1;
  float* part = partial + blockIdx.x * p_total;
  const LossComp<float> pol{in, dm, dvec, target, inv_n};
  const float sq_err = nerf_cmma::backward_groups<LossComp<float>, K>(
      pol, smem16, dm, L, M, F, Bp, B, part, acts_all + blockIdx.x * nerf_cmma::act_elems<K>(in.S),
      dx_all + (size_t)blockIdx.x * K::BM * dm.xyz, dz, raw, in.R, in.S, groups);
  if (threadIdx.x == 0) part[p_total - 1] = sq_err * inv_n;
  T32_END();
}

static int launch(bool bf16, const Dims& dm, const void* enc, const float* encd, const float* z,
                  const float* dvec, const float* target, float inv_n, int R, int S,
                  const void* w, const void* wt, const float* b, float* dz, float* raw,
                  float* partial, void* acts, float* dxs, float* out, int n_blocks,
                  cudaStream_t stream) {
  const int groups = nerf_comp_groups(bf16, R, S);
  if (groups == 0 || n_blocks <= 0 || n_blocks > groups || dm.xyz < 3 || (dm.xyz - 3) % 6 != 0 ||
      dxs == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(dm);
  cudaError_t err;
  if (bf16) {
    using nerf_mma::bf16;
    const EncRays<bf16> in{static_cast<const bf16*>(enc), encd, z, R, S};
    const size_t smem = nerf_cmma::smem_bytes(S);
    err = cudaFuncSetAttribute(mlp_loss_comp_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_loss_comp_mma_kernel<<<n_blocks, nerf_mma::NT, smem, stream>>>(
        dm, L, nerf_mma::make_mma_layout(L), in, dvec, target, inv_n,
        static_cast<const bf16*>(w), static_cast<const bf16*>(wt), b, dz, raw, partial,
        static_cast<bf16*>(acts), dxs, groups);
  } else {
    const EncRays<float> in{static_cast<const float*>(enc), encd, z, R, S};
    const size_t smem = nerf_cmma::smem_bytes<nerf_tmma::Kit>(S);
    err = cudaFuncSetAttribute(mlp_loss_comp_t32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_loss_comp_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>(
        dm, L, nerf_tmma::make_t32_layout(L), in, dvec, target, inv_n,
        static_cast<const float*>(w), static_cast<const float*>(wt), b, dz, raw, partial,
        static_cast<float*>(acts), dxs, groups);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b + 1, out, stream);
}

// enc, encd, z as nerf_mlp_comp_fwd's; dvec (R, 3) unnormalised ray directions
// and target (R, 3) pixels, f32; inv_n = 1 / (3 R). Out: dz (R, S) f32 and
// `out` (nerf_mlp_param_count + 1) f32: the weight gradients, the bias
// gradients, then the loss. Scratch the caller allocates: partial (n_blocks *
// (nerf_mlp_param_count + 1)) f32, acts (n_blocks *
// nerf_comp_act_elems(is_bf16, S)) elements of the compute type and dxs
// (n_blocks * nerf_comp_dx_rows(is_bf16) * xyz) f32, with 1 <= n_blocks <=
// nerf_comp_groups(is_bf16, R, S). w, wt: for bf16 the F and B packs
// (mlp_mma_tile.cuh), for f32 the F and B buffers of mlp_tf32_mma_tile.cuh
// (raymarch_cuda.t32_packs). raw: null, or (R, S, 4) f32 that receives the
// raw values composited.
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_mlp_loss_comp(int is_bf16, int has_dir, const void* enc, const float* encd,
                                  const float* z, const float* dvec, const float* target,
                                  const void* w, const void* wt, const float* b, float* dz,
                                  float* raw, float* partial, void* acts, float* dxs, float* out,
                                  int n_blocks, int R, int S, int xyz, int dir, int hid, int last,
                                  float alpha, float inv_n, void* stream) {
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  return launch(is_bf16 != 0, dm, enc, encd, z, dvec, target, inv_n, R, S, w, wt, b, dz, raw,
                partial, acts, dxs, out, n_blocks, static_cast<cudaStream_t>(stream));
}
