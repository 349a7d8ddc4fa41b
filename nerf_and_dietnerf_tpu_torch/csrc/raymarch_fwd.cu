// B6 forward: points, both encodings and the radiance MLP from per-ray data.
//
// Replaces nerf_and_dietnerf_tpu/ops/research_kernels.py `_forward_rays_pallas`
// (body `_make_forward_rays`: `_encode_tile` then `_forward_tile`): from rays
// (R, 6 + D) f32 and z (R, S) f32, each row's point o + z d, its xyz and view
// encodings rounded to the compute type, then B1's network; (R, S, 4) f32 out.
//
// What bounds it on an H100: operations, as B1 (about 1.024 MFLOP per row at
// the flagship widths), now against only 4 bytes of z and 36 / S bytes of ray
// data in per row (the (N, 33) + (N, 24) encodings B1 reads are never in
// device memory) and 16 bytes out.
//
// What the design does about that: B1's tensor-core tiles on inputs the
// kernel builds itself (raymarch_tile.cuh); the encodings go from registers
// into shared memory and never to device memory.
// - bf16 (every `pallas_rm` train step): `mma.sync` 128-row tiles
//   (mlp_mma_tile.cuh), X and D built straight into the tile's bf16 operand
//   tiles; `w` is the F pack.
// - f32 (the `pallas_rm` eval renders and video frames): 3xTF32 `wgmma` in
//   persistent blocks (mlp_tf32_tile.cuh), each consumer warp building its
//   rows' f32 features into 64 input columns of their tile rows, which two
//   ring stages make room for; `w` is the hi / lo weight buffer. Widths whose
//   features do not fit those columns (pad8(xyz) + pad8(dir) > 64; no config
//   of the repository) keep the FMA tile of mlp_common.cuh on the flat
//   weights (64-row tiles, build_inputs).
// The TPU kernel's sample-major row layout, one-hot expansion matmuls and
// weight-row permutation exist for Mosaic only and are not carried over: rows
// stay ray-major and the features keep the reference's column order.
#include "raymarch_tile.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

// bf16: one 128-row tile per block on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    rm_fwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, Rays ry,
                      const nerf_mma::bf16* __restrict__ F, const float* __restrict__ B,
                      float* __restrict__ out) {
  extern __shared__ uint4 smem16[];
  const nerf_mma::Tiles t = nerf_mma::make_tiles(smem16, false);
  nerf_mma::Ring ring{t.ring, 0};
  nerf_mma::ring_start(ring, nerf_mma::fmat(F, M, 0));
  const int row0 = blockIdx.x * nerf_mma::BM;
  build_mma_inputs(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);
  __syncthreads();
  nerf_mma::forward_tile(dm, L, M, F, B, t, ring, nullptr, out, row0, nullptr);
}

// f32: persistent blocks of three warpgroups, 128-row tiles.
__global__ void __launch_bounds__(nerf_tf32::NT, 1)
    rm_fwd_tf32_kernel(Dims dm, Layout L, nerf_tf32::Tf32Layout T,
                       const __grid_constant__ RayTf32Inputs in, const float* __restrict__ W,
                       const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ uint4 smem_tf32[];
  nerf_tf32::forward(dm, L, T, in, W, B, out, smem_tf32);
}

// f32 at widths beyond the input columns: the FMA tile, 64-row tiles.
__global__ void __launch_bounds__(NT, 1)
    rm_fwd_fma_kernel(Dims dm, Layout L, Rays ry, const float* __restrict__ W,
                      const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bufA = reinterpret_cast<float*>(smem4);
  float* bufB = bufA + TM * HMAX;
  float* Ws = bufB + TM * HMAX;
  float* X = Ws + KC * HMAX;
  float* D = X + TM * XMAX;
  const int row0 = blockIdx.x * TM;
  build_inputs<float>(ry, dm.xyz, dm.dir, row0, dm.n, X, D);
  __syncthreads();
  forward_tile<float>(dm, L, W, B, X, D, bufA, bufB, Ws, out, row0);
}

static int launch(bool bf16, const Dims& dm, const Rays& ry, const void* w, const float* b,
                  float* out, cudaStream_t stream) {
  if (dm.n == 0) return 0;
  const Layout L = make_layout(dm);
  if (bf16) {
    const int tiles = (dm.n + nerf_mma::BM - 1) / nerf_mma::BM;
    return (int)launch_kernel(rm_fwd_mma_kernel, tiles, nerf_mma::NT, nerf_mma::fwd_smem_bytes(),
                              stream, dm, L, nerf_mma::make_mma_layout(L), ry,
                              static_cast<const nerf_mma::bf16*>(w), b, out);
  }
  const float* wf = static_cast<const float*>(w);
  if (!tf32_inputs_fit(dm.xyz, dm.dir)) {
    const int tiles = (dm.n + TM - 1) / TM;
    return (int)launch_kernel(rm_fwd_fma_kernel, tiles, NT, fwd_smem_bytes(), stream, dm, L, ry,
                              wf, b, out);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (dm.n + nerf_tf32::BM - 1) / nerf_tf32::BM;
  return (int)launch_kernel(rm_fwd_tf32_kernel, tiles < sms ? tiles : sms, nerf_tf32::NT,
                            nerf_tf32::smem_bytes<RayTf32Inputs>(), stream, dm, L,
                            nerf_tf32::make_tf32_layout(L), RayTf32Inputs{ry, dm.xyz, dm.dir},
                            wf, b, out);
}

// w: for bf16 the F pack (mlp_mma_tile.cuh, nerf_mlp_mma_pack_elems
// elements); for f32 the weight buffer of mlp_tf32_tile.cuh (two packs of
// nerf_mlp_tf32_pack_elems floats, then the head weights) where
// nerf_rm_fwd_tf32_tile says so, else the flat weights. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_rm_fwd(int is_bf16, int has_dir, const float* rd, const float* z,
                           const void* w, const float* b, float* out, int R, int S, int L, int Ld,
                           int D, int xyz, int dir, int hid, int last, float alpha, void* stream) {
  if (xyz != 3 + 6 * L || (has_dir ? (D <= 0 || dir != 2 * Ld * D) : D != 0))
    return (int)cudaErrorInvalidValue;
  const Dims dm{R * S, xyz, dir, hid, last, has_dir, alpha};
  const Rays ry{rd, z, R, S, L, Ld, D};
  return launch(is_bf16 != 0, dm, ry, w, b, out, static_cast<cudaStream_t>(stream));
}

// 1 if the f32 forward at these widths runs on the tensor cores (and reads
// the TF32 weight buffer), 0 if on the FMA tile (the flat weights).
extern "C" int nerf_rm_fwd_tf32_tile(int xyz, int dir) { return tf32_inputs_fit(xyz, dir); }
