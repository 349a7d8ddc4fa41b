// B2: backward of the radiance MLP, recomputing the forward in each tile.
//
// Replaces nerf_and_dietnerf_tpu/ops/raymarch_pallas.py `_backward_pallas`
// (body `_backward_tile`): re-run the forward on the tile, then walk the chain
// back, emitting dx (n, xyz) f32, dd (n, dir) f32 and the f32 weight and bias
// gradients summed over all rows. As there: the leaky gradient takes the sign
// of the post-activation (ties >= 0 take the identity branch), gradients are
// rounded to the compute type before each product, the rgb/sigma output
// cotangents enter the weight products in f32.
//
// What bounds it on an H100: operations. About 3 x 1.024 MFLOP per row (the
// recomputed forward, the input-gradient chain and the weight-gradient
// products), against 16 + 48 + 16 bytes in and 228 bytes out per row (bf16;
// f32 reads 132 + 96 + 16).
//
// What the design does about that: every product wider than 3 runs on the
// tensor cores; the gradient tiles stay in shared memory, the tile's
// recomputed activations are kept in the compute type in a per-block scratch
// slab (the backward needs all ten of them, more than shared memory holds
// next to the gradient tiles), and the weights stream through shared memory
// (W^T for the forward, W for g @ W^T, pre-packed by the wrapper).
// - bf16 (the train step): 128-row tiles, `mma.sync.m16n8k16` (the
//   recomputed forward, g @ W^T and the weight gradients A^T G;
//   mlp_mma_tile.cuh). `w` / `wt` are then the F and B packs of that header.
// - f32 (parity runs, configs with compute_dtype float32): 64-row tiles,
//   3xTF32 `mma.sync.m16n8k8` (nerf_tmma::backward_tile of
//   mlp_tf32_mma_tile.cuh: forward_tile keeping the slots, then the walk, as
//   f32 B7's backward runs them); X and D loaded swizzled with zero pads
//   (load_rows). `w` / `wt` are the F and B buffers of
//   raymarch_cuda.t32_packs.
// The Pallas kernel summed weight gradients over a sequential grid; blocks
// here run in no order, so each block walks a fixed, strided set of tiles and
// sums into its own slab of the `partial` buffer (one thread owns each entry,
// no atomics), and a second launch adds the slabs in block order. Two runs on
// the same inputs therefore give bitwise-equal gradients.
#include "grad_slabs.cuh"
#include "mlp_mma_tile.cuh"
#include "mlp_tf32_mma_tile.cuh"

using namespace nerf_mlp;

// f32: strided 64-row tiles per block on the 3xTF32 tensor-core tile.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    mlp_bwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, const float* __restrict__ x,
                       const float* __restrict__ d, const float* __restrict__ F,
                       const float* __restrict__ Bp, const float* __restrict__ B,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ dd, float* __restrict__ partial,
                       float* __restrict__ acts_all, int n_tiles) {
  namespace tm = nerf_tmma;
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const tm::Tiles t = tm::make_tiles(smem16, true);
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  float* acts = acts_all + (size_t)blockIdx.x * tm::NACT * tm::SLOT;
  const tm::Mat f0 = tm::fmat(F, M, 0);
  tm::Ring ring{t.ring, 0};
  tm::ring_start(ring, f0);
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * tm::BM;
    T32_PHASE(nerf_t32ph::INPUTS);
    tm::load_rows(t.X, tm::LDX, x, dm.xyz, row0, dm.n);
    if (dm.has_dir) tm::load_rows(t.D, tm::LDD, d, dm.dir, row0, dm.n);
    tm::load_cotangent(t.GI, g, row0, dm.n);
    __syncthreads();
    const bool more = tile + (int)gridDim.x < n_tiles;
    tm::backward_tile(dm, L, M, F, Bp, B, t, ring, acts, part, first, row0, dx,
                      dm.has_dir ? dd : nullptr, more ? &f0 : nullptr);
  }
  T32_END();
}
// Its tiles and slots are the ones the f32 exports below give.
static_assert(nerf_tmma::BM == TM && (long long)nerf_tmma::NACT * nerf_tmma::SLOT ==
                                         (long long)NACT * TM * HMAX,
              "f32 tiles and slots as nerf_mlp_bwd_tile_rows / _act_elems size them");

// bf16: strided 128-row tiles per block on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    mlp_bwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ d, const __nv_bfloat16* __restrict__ F,
                       const __nv_bfloat16* __restrict__ Bp, const float* __restrict__ B,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ dd, float* __restrict__ partial,
                       __nv_bfloat16* __restrict__ acts_all, int n_tiles) {
  using namespace nerf_mma;
  extern __shared__ uint4 smem16[];
  const Tiles t = make_tiles(smem16, true);
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  bf16* acts = acts_all + (size_t)blockIdx.x * nerf_mma::NACT * SLOT;
  const Mat f0 = fmat(F, M, 0);
  Ring ring{t.ring, 0};
  ring_start(ring, f0);
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * BM;
    load_tile(t.X, LDX, x, dm.xyz, row0, dm.n);
    if (dm.has_dir) load_tile(t.D, LDD, d, dm.dir, row0, dm.n);
    nerf_mma::load_cotangent(t.GI, g, row0, dm.n);
    __syncthreads();
    const bool more = tile + (int)gridDim.x < n_tiles;
    nerf_mma::backward_tile(dm, L, M, F, Bp, B, t, ring, acts, part, first, row0, dx,
                            dm.has_dir ? dd : nullptr, more ? &f0 : nullptr);
  }
}

template <typename T>
static int launch(const Dims& dm, const void* x, const void* d, const void* w, const void* wt,
                  const float* b, const float* g, float* dx, float* dd, float* partial,
                  void* acts, float* dparams, int n_blocks, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  constexpr bool mma = std::is_same<T, __nv_bfloat16>::value;
  const int rows = mma ? nerf_mma::BM : nerf_tmma::BM;
  const int tiles = (dm.n + rows - 1) / rows;
  if (tiles == 0 || n_blocks <= 0 || n_blocks > tiles) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (mma) {
    const size_t smem = nerf_mma::bwd_smem_bytes();
    err = cudaFuncSetAttribute(mlp_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_mma_kernel<<<n_blocks, nerf_mma::NT, smem, stream>>>(
        dm, L, nerf_mma::make_mma_layout(L), static_cast<const T*>(x), static_cast<const T*>(d),
        static_cast<const T*>(w), static_cast<const T*>(wt), b, g, dx, dd, partial,
        static_cast<T*>(acts), tiles);
  } else {
    const size_t smem = nerf_tmma::bwd_smem_bytes();
    err = cudaFuncSetAttribute(mlp_bwd_t32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_t32_kernel<<<n_blocks, nerf_tmma::NT, smem, stream>>>(
        dm, L, nerf_tmma::make_t32_layout(L), static_cast<const T*>(x),
        static_cast<const T*>(d), static_cast<const T*>(w), static_cast<const T*>(wt), b, g, dx,
        dd, partial, static_cast<T*>(acts), tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// Scratch the caller allocates: partial (n_blocks * (total_w + total_b)) f32
// and acts (n_blocks * nerf_mlp_bwd_tile_act_elems(is_bf16)) elements of the
// compute type, with 1 <= n_blocks <= ceil(n / nerf_mlp_bwd_tile_rows(is_bf16)).
// w, wt: for bf16 the F and B packs (mlp_mma_tile.cuh), for f32 the F and B
// buffers of mlp_tf32_mma_tile.cuh (hi pack, lo pack, flat heads:
// raymarch_cuda.t32_packs). Returns cudaGetLastError() (0 on success).
extern "C" int nerf_mlp_bwd(int is_bf16, int has_dir, const void* x, const void* d,
                            const void* w, const void* wt, const float* b, const float* g,
                            float* dx, float* dd, float* partial, void* acts, float* dparams,
                            int n_blocks, int n, int xyz, int dir, int hid, int last, float alpha,
                            void* stream) {
  const Dims dm{n, xyz, dir, hid, last, has_dir, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, x, d, w, wt, b, g, dx, dd, partial, acts, dparams,
                                         n_blocks, s)
                 : launch<float>(dm, x, d, w, wt, b, g, dx, dd, partial, acts, dparams,
                                 n_blocks, s);
}

// Rows of a tile and activation-slot elements of a block, by compute type
// (f32: the 64-row tiles of mlp_tf32_mma_tile.cuh, as asserted above).
extern "C" int nerf_mlp_bwd_tile_rows(int is_bf16) { return is_bf16 ? nerf_mma::BM : TM; }
extern "C" long long nerf_mlp_bwd_tile_act_elems(int is_bf16) {
  return is_bf16 ? (long long)nerf_mma::NACT * nerf_mma::SLOT : (long long)NACT * TM * HMAX;
}
