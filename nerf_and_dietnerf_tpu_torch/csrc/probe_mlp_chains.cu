// P3: B1's bf16 forward with C row chains of 64 rows a block, to see whether
// using each streamed weight chunk for more or fewer rows pays.
//
// Replaces tools/exp_interleave.py `fwd_pallas` (body `make_fwd`): B1's
// arithmetic (view-dir variant) with the tile split into C independent row
// chains whose products sit side by side; the output is B1's for every split.
// On the TPU the question was whether the matrix unit's pipeline fills. Here
// a block copies every 32-column weight chunk from L2 into its `cp.async`
// ring and waits for it behind a block-wide barrier; its C chains use the
// chunk for C x 64 rows. C = 2 is B1's own tile (128 rows, 8 warps). C = 1
// runs 64-row blocks of 4 warps; two fit an SM (nerf_probe_chains_blocks_per_sm),
// which so holds B1's 8 warps but loads each chunk twice as often for the
// same rows, behind barriers of 4 warps instead of 8.
//
// What bounds it on an H100: operations, as B1: about 1.024 MFLOP a row at
// the flagship widths, 805 GFLOP at the tool's 786,432 rows, at least 0.81 ms
// at 989 TFLOP/s (bf16, dense).
//
// What the design does about that: it is B1. The kernel runs
// nerf_mma::forward_tile (mlp_mma_tile.cuh) on a tile of WM = C row halves:
// every warp keeps B1's 64-row by 64-column accumulators, and per row the
// sums run in B1's k order on B1's `mma.sync.m16n8k16` steps, so every C that
// runs gives B1's output bitwise. Shared memory: P 33,792 + X 9,216 + D 5,120
// + sigma 256 = 48,384 bytes a chain, plus the 40,960-byte ring
// (fwd_smem_bytes<C>: 89,344 at C = 1, 137,728 at C = 2). C = 4 does not fit
// a block: 234,496 bytes of shared memory against the 232,448 it may use, so
// the wrapper refuses it (SharedMemoryExceeded). Its 512 threads could also
// have at most 128 registers each, fewer than ptxas gives a thread at C = 1
// and 2 (chip_smoke.py records both).
//
// Why B1's `mma.sync` tile and not `wgmma`: the probe only means something as
// "B1 with one thing changed". Moving B1 itself onto `wgmma` is its own
// redesign (ROADMAP R2); the probe follows B1 there when B1 moves.
#include "mlp_mma_tile.cuh"

using nerf_mlp::Dims;
using nerf_mlp::Layout;
using namespace nerf_mma;

template <int C>
__global__ void __launch_bounds__(NT_OF<C>, 1)
    mlp_fwd_chains_kernel(Dims dm, Layout L, MmaLayout M, const bf16* __restrict__ x,
                          const bf16* __restrict__ d, const bf16* __restrict__ F,
                          const float* __restrict__ B, float* __restrict__ out) {
  extern __shared__ uint4 smem16[];
  const Tiles t = make_tiles<C>(smem16, false);
  Ring ring{t.ring, 0};
  ring_start<C>(ring, fmat(F, M, 0));
  const int row0 = blockIdx.x * BM_OF<C>;
  load_tile<C>(t.X, LDX, x, dm.xyz, row0, dm.n);
  load_tile<C>(t.D, LDD, d, dm.dir, row0, dm.n);
  __syncthreads();
  forward_tile<LeakyEpilogue, C>(dm, L, M, F, B, t, ring, nullptr, out, row0, nullptr);
}

template <int C>
static int launch(const Dims& dm, const bf16* x, const bf16* d, const bf16* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = nerf_mlp::make_layout(dm);
  const size_t smem = fwd_smem_bytes<C>();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_chains_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (dm.n + BM_OF<C> - 1) / BM_OF<C>;
  mlp_fwd_chains_kernel<C><<<blocks, NT_OF<C>, smem, stream>>>(dm, L, make_mma_layout(L), x, d,
                                                               w, b, out);
  return (int)cudaGetLastError();
}

template <int C>
static int blocks_per_sm() {
  const size_t smem = fwd_smem_bytes<C>();
  int blocks = -1;
  if (cudaFuncSetAttribute(mlp_fwd_chains_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mlp_fwd_chains_kernel<C>, NT_OF<C>,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Blocks of `n_chains` chains that an SM holds at once, as the occupancy
// calculator gives it for the kernel's registers, threads and shared memory
// (-1 for other counts, or on an error).
extern "C" int nerf_probe_chains_blocks_per_sm(int n_chains) {
  switch (n_chains) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    default: return -1;
  }
}

// Shared memory a block of `n_chains` chains needs, in bytes (also for 4,
// which no kernel runs); -1 for other counts.
extern "C" long long nerf_probe_chains_smem(int n_chains) {
  switch (n_chains) {
    case 1: return (long long)fwd_smem_bytes<1>();
    case 2: return (long long)fwd_smem_bytes<2>();
    case 4: return (long long)fwd_smem_bytes<4>();
    default: return -1;
  }
}

// n_chains: 1 or 2; x, d: bf16; w: the F pack (nerf_mlp_mma_pack_elems
// elements), as B1's. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int nerf_probe_mlp_chains(int n_chains, const void* x, const void* d, const void* w,
                                     const float* b, float* out, int n, int xyz, int dir, int hid,
                                     int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, 1, alpha};
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *db = static_cast<const bf16*>(d),
             *wb = static_cast<const bf16*>(w);
  switch (n_chains) {
    case 1: return launch<1>(dm, xb, db, wb, b, out, s);
    case 2: return launch<2>(dm, xb, db, wb, b, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
