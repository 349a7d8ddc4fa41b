// B1: forward of the radiance MLP, one row tile per thread block.
//
// Replaces nerf_and_dietnerf_tpu/ops/raymarch_pallas.py `_forward_pallas`
// (body `_forward_tile`): 8 leaky trunk layers with the skip as
// x @ W4a + h @ W4b, then the view-dir heads ((h8 | d) -> last -> 3 and sigma
// from (h8 | d)) or the xyz-only heads (256 -> 256 -> last -> 3, sigma from
// h8); bf16 or f32 operands, f32 sums, activations rounded to the compute
// type after each leaky, (n, 4) f32 out.
//
// What bounds it on an H100: operations. About 1.024 MFLOP per row at the
// flagship widths (33 -> 8 x 256 -> 280 -> 128 -> 3), against 16 + 48 input
// bytes and 16 output bytes per row, so it is far above the card's
// operations-per-byte line in either type.
//
// What the design does about that: no activation leaves the chip. A block
// keeps its row tile's activations in shared memory for the whole network
// and streams each layer's weights through shared memory (the whole net is
// about 1 MB in bf16, 2 MB in f32, more than a block's 227 KB; the weights
// stay hot in L2 across blocks). Both types run their products on the
// tensor cores:
// - bf16 (the train step): `mma.sync.m16n8k16`, 128-row tiles, weights
//   pre-packed by the wrapper and streamed with `cp.async` (see
//   mlp_mma_tile.cuh). `w` is then the F pack of that header.
// - f32 (the eval renders and video frames, true f32): 3xTF32 `wgmma`,
//   128-row tiles in persistent blocks, a producer warp streaming hi / lo
//   weight packs with bulk copies (see mlp_tf32_tile.cuh). `w` is then the
//   weight buffer of that header.
#include "mlp_common.cuh"
#include "mlp_mma_tile.cuh"
#include "mlp_tf32_tile.cuh"

using namespace nerf_mlp;

// f32: persistent blocks of three warpgroups, 128-row tiles.
__global__ void __launch_bounds__(nerf_tf32::NT, 1)
    mlp_fwd_tf32_kernel(Dims dm, Layout L, nerf_tf32::Tf32Layout T, const float* __restrict__ x,
                        const float* __restrict__ d, const float* __restrict__ W,
                        const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ uint4 smem_tf32[];
  nerf_tf32::forward(dm, L, T, nerf_tf32::GlobalInputs{x, d, dm.xyz, dm.dir}, W, B, out,
                     smem_tf32);
}

// bf16: one 128-row tile per block on the tensor cores.
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    mlp_fwd_mma_kernel(Dims dm, Layout L, nerf_mma::MmaLayout M, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ d, const __nv_bfloat16* __restrict__ F,
                       const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ uint4 smem16[];
  const nerf_mma::Tiles t = nerf_mma::make_tiles(smem16, false);
  nerf_mma::Ring ring{t.ring, 0};
  nerf_mma::ring_start(ring, nerf_mma::fmat(F, M, 0));
  const int row0 = blockIdx.x * nerf_mma::BM;
  nerf_mma::load_tile(t.X, nerf_mma::LDX, x, dm.xyz, row0, dm.n);
  if (dm.has_dir) nerf_mma::load_tile(t.D, nerf_mma::LDD, d, dm.dir, row0, dm.n);
  __syncthreads();
  nerf_mma::forward_tile(dm, L, M, F, B, t, ring, nullptr, out, row0, nullptr);
}

template <typename T>
static int launch(const Dims& dm, const void* x, const void* d, const void* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  if (dm.n == 0) return 0;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = nerf_mma::fwd_smem_bytes();
    err = cudaFuncSetAttribute(mlp_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (dm.n + nerf_mma::BM - 1) / nerf_mma::BM;
    mlp_fwd_mma_kernel<<<tiles, nerf_mma::NT, smem, stream>>>(
        dm, L, nerf_mma::make_mma_layout(L), static_cast<const T*>(x), static_cast<const T*>(d),
        static_cast<const T*>(w), b, out);
  } else {
    const size_t smem = nerf_tf32::smem_bytes<nerf_tf32::GlobalInputs>();
    err = cudaFuncSetAttribute(mlp_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (dm.n + nerf_tf32::BM - 1) / nerf_tf32::BM;
    mlp_fwd_tf32_kernel<<<tiles < sms ? tiles : sms, nerf_tf32::NT, smem, stream>>>(
        dm, L, nerf_tf32::make_tf32_layout(L), static_cast<const float*>(x),
        static_cast<const float*>(d), static_cast<const float*>(w), b, out);
  }
  return (int)cudaGetLastError();
}

// w: for bf16 the F pack (mlp_mma_tile.cuh, nerf_mlp_mma_pack_elems
// elements), for f32 the weight buffer of mlp_tf32_tile.cuh (two packs of
// nerf_mlp_tf32_pack_elems floats, then the head weights). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_mlp_fwd(int is_bf16, int has_dir, const void* x, const void* d,
                            const void* w, const float* b, float* out, int n, int xyz, int dir,
                            int hid, int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, has_dir, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dm, x, d, w, b, out, s)
                 : launch<float>(dm, x, d, w, b, out, s);
}
