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
// What the design does about that: B2's tile on inputs built on chip, then
// one thread per row turns the row's dx into dz (dtheta = dx * cos(theta),
// dpts = sum f_k dtheta + dx_id, dz = dpts . d; dz_of_row). Either type runs
// B2's tile as on a call of its own (row0 0, n the tile's rows): its X and D
// built straight into the tile's operand tiles (raymarch_tile.cuh), its dx
// rows written to a slab of the block's own, BM x xyz f32 (`dxs`, held in L2:
// backward_tile writes dx rows to global memory, the skip layer writes,
// layer 0 adds), from which, after a barrier, each thread reads its row back.
// That keeps backward_tile and its shared memory exactly B2's.
// - bf16 (every `pallas_rm` train step): B2's tensor-core tile
//   (mlp_mma_tile.cuh `backward_tile`, unchanged) on 128-row tiles, X and D
//   rounded to bf16; `w` / `wt` are the F and B packs; the slab 2.2 MB for
//   132 blocks at xyz = 33; shared memory 209,408 bytes.
// - f32 (configs with compute_dtype float32, parity runs): f32 B2's 3xTF32
//   tile (mlp_tf32_mma_tile.cuh `backward_tile`) on 64-row tiles, X and D
//   stored swizzled with zero pads (build_t32_inputs); `w` / `wt` are the F
//   and B buffers of raymarch_cuda.t32_packs; shared memory 198,912 bytes.
// Weight gradients are summed as in B2: each block walks a fixed, strided set
// of tiles into its own slab, and a second launch adds the slabs in block
// order, so two runs give bitwise-equal gradients.
#include "grad_slabs.cuh"
#include "raymarch_tile.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

// f32: strided 64-row tiles per block on the 3xTF32 tensor-core tile.
__global__ void __launch_bounds__(nerf_tmma::NT, 1)
    rm_bwd_t32_kernel(Dims dm, Layout L, nerf_tmma::T32Layout M, Rays ry,
                      const float* __restrict__ F, const float* __restrict__ Bp,
                      const float* __restrict__ B, const float* __restrict__ g,
                      float* __restrict__ dz, float* __restrict__ partial,
                      float* __restrict__ acts_all, float* __restrict__ dx_all, int n_tiles) {
  namespace tm = nerf_tmma;
  extern __shared__ uint4 smem16[];
  T32_BEGIN();
  const tm::Tiles t = tm::make_tiles(smem16, true);
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  float* acts = acts_all + (size_t)blockIdx.x * tm::NACT * tm::SLOT;
  float* dxs = dx_all + (size_t)blockIdx.x * tm::BM * dm.xyz;
  const tm::Mat f0 = tm::fmat(F, M, 0);
  tm::Ring ring{t.ring, 0};
  tm::ring_start(ring, f0);
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * tm::BM;
    T32_PHASE(nerf_t32ph::INPUTS);
    build_t32_inputs(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);
    tm::load_cotangent(t.GI, g, row0, dm.n);
    __syncthreads();
    Dims tile_dm = dm;  // the tile as a call of its own: its dx rows go to dxs
    tile_dm.n = min(tm::BM, dm.n - row0);
    const bool more = tile + (int)gridDim.x < n_tiles;
    tm::backward_tile(tile_dm, L, M, F, Bp, B, t, ring, acts, part, first, 0, dxs, nullptr,
                      more ? &f0 : nullptr);
    T32_PHASE(nerf_t32ph::DZ);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < tile_dm.n) dz[row0 + r] = dz_of_row(ry, dxs + r * dm.xyz, row0 + r);
  }
  T32_END();
}
// Its tiles and slots are the ones the f32 exports below give.
static_assert(nerf_tmma::BM == TM && (long long)nerf_tmma::NACT * nerf_tmma::SLOT ==
                                         (long long)NACT * TM * HMAX,
              "f32 tiles and slots as nerf_mlp_bwd_tile_rows / _act_elems size them");

// bf16: strided 128-row tiles per block on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    rm_bwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, Rays ry,
                      const nerf_mma::bf16* __restrict__ F, const nerf_mma::bf16* __restrict__ Bp,
                      const float* __restrict__ B, const float* __restrict__ g,
                      float* __restrict__ dz, float* __restrict__ partial,
                      nerf_mma::bf16* __restrict__ acts_all, float* __restrict__ dx_all,
                      int n_tiles) {
  using nerf_mma::BM;
  extern __shared__ uint4 smem16[];
  const nerf_mma::Tiles t = nerf_mma::make_tiles(smem16, true);
  const size_t p_total = (size_t)L.total_w + L.total_b;
  float* part = partial + blockIdx.x * p_total;
  nerf_mma::bf16* acts = acts_all + (size_t)blockIdx.x * nerf_mma::NACT * nerf_mma::SLOT;
  float* dxs = dx_all + (size_t)blockIdx.x * BM * dm.xyz;
  const nerf_mma::Mat f0 = nerf_mma::fmat(F, M, 0);
  nerf_mma::Ring ring{t.ring, 0};
  nerf_mma::ring_start(ring, f0);
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * BM;
    build_mma_inputs(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);
    nerf_mma::load_cotangent(t.GI, g, row0, dm.n);
    __syncthreads();
    Dims tile_dm = dm;  // the tile as a call of its own: its dx rows go to dxs
    tile_dm.n = min(BM, dm.n - row0);
    const bool more = tile + (int)gridDim.x < n_tiles;
    nerf_mma::backward_tile(tile_dm, L, M, F, Bp, B, t, ring, acts, part, first, 0, dxs, nullptr,
                            more ? &f0 : nullptr);
    __syncthreads();
    const int r = threadIdx.x;
    if (r < tile_dm.n) dz[row0 + r] = dz_of_row(ry, dxs + r * dm.xyz, row0 + r);
  }
}

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const void* wt,
                  const float* b, const float* g, float* dz, float* partial, void* acts,
                  float* dxs, float* dparams, int n_blocks, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int rows = bf16 ? nerf_mma::BM : nerf_tmma::BM;
  const int tiles = (dm.n + rows - 1) / rows;
  if (tiles == 0 || n_blocks <= 0 || n_blocks > tiles || dxs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = launch_kernel(rm_bwd_mma_kernel, n_blocks, nerf_mma::NT, nerf_mma::bwd_smem_bytes(),
                        stream, dm, L, nerf_mma::make_mma_layout(L), ry,
                        static_cast<const nerf_mma::bf16*>(w),
                        static_cast<const nerf_mma::bf16*>(wt), b, g, dz, partial,
                        static_cast<nerf_mma::bf16*>(acts), dxs, tiles);
  } else {
    err = launch_kernel(rm_bwd_t32_kernel, n_blocks, nerf_tmma::NT, nerf_tmma::bwd_smem_bytes(),
                        stream, dm, L, nerf_tmma::make_t32_layout(L), ry,
                        static_cast<const float*>(w), static_cast<const float*>(wt), b, g, dz,
                        partial, static_cast<float*>(acts), dxs, tiles);
  }
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, n_blocks, (size_t)L.total_w + L.total_b, dparams, stream);
}

// g: (R, S, 4) f32 cotangent of the raw output; dz: (R, S) f32. Scratch the
// caller allocates: partial (n_blocks * params) f32, acts (n_blocks *
// nerf_mlp_bwd_tile_act_elems(is_bf16)) of the compute type and dxs
// (n_blocks * nerf_mlp_bwd_tile_rows(is_bf16) * xyz) f32, with 1 <= n_blocks
// <= ceil(R S / nerf_mlp_bwd_tile_rows(is_bf16)). w, wt: for bf16 the F and B
// packs (mlp_mma_tile.cuh), for f32 the F and B buffers of
// mlp_tf32_mma_tile.cuh (raymarch_cuda.t32_packs).
// Returns cudaGetLastError() (0 on success).
extern "C" int nerf_rm_bwd(int is_bf16, int has_dir, const float* rd, const float* z,
                           const void* w, const void* wt, const float* b, const float* g,
                           float* dz, float* partial, void* acts, float* dxs, float* dparams,
                           int n_blocks, int R, int S, int L, int Ld, int D, int xyz, int dir,
                           int hid, int last, float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  return launch(is_bf16 != 0, dm, ry, w, wt, b, g, dz, partial, acts, dxs, dparams, n_blocks,
                static_cast<cudaStream_t>(stream));
}

// Rows of a tile and activation-slot elements of a block, by compute type.
extern "C" int nerf_mlp_bwd_tile_rows(int is_bf16) { return is_bf16 ? nerf_mma::BM : TM; }
extern "C" long long nerf_mlp_bwd_tile_act_elems(int is_bf16) {
  return is_bf16 ? (long long)nerf_mma::NACT * nerf_mma::SLOT : (long long)NACT * TM * HMAX;
}
