// Branch sinks of the backward tiles: a compile-time policy at every place
// where a backward takes a leaky slope (grad_tile and the rgb head's slope in
// backward_walk, of mlp_mma_tile.cuh and mlp_tf32_mma_tile.cuh). Both kits
// recompute the forward in the tile and take each slope from the sign of the
// recomputed post-activation; a row whose pre-activation lies within
// rounding of 0 may take the other slope than an f64 evaluation does, and
// moves its share of every weight gradient with it. A recording build lets
// the checks evaluate their reference on the kernel's own branches
// (raymarch_cuda.unpack_branches, branch_guard).
//
// Every kernel instantiates its backward with nerf_br::Sink: NoBranches,
// whose calls compile to nothing, in the libraries the port loads; with
// -DNERF_BRANCHES (kernel_lib's recording builds, a directory of their own)
// RecordBranches, which writes each slope it is told of:
//   Sink::tile(a, b, j, n, bm)  before the barrier that precedes a tile's
//       walk: the tile's row 0 is row a b + j bm of the kernel's row order
//       (ray-major (ray, sample) for B4-B7: a the group's first ray, b the
//       samples a ray, j the tile of the group; the input rows for B2 and
//       B6: a = b = 0, j the tile), and its rows past min(bm, n - j bm) are
//       pads, which are not recorded. The callers pass values they already
//       hold, so that no argument adds an operation to the production code;
//   Sink::record(layer, r, c, pos)  for tile row r, column c < the layer's
//       width: pos is whether the positive slope was taken;
//   Sink::record_pair(layer, r, c, N, p)  the f32 tile's columns c and c + 1
//       (those below N), whose slopes the signs of the post-activations p.x
//       and p.y picked (p >= 0: the positive slope).
// The mask nerf_branch_buffer names is (layers, rows, width) bytes, layer-
// major: layers 0-7 the trunk, then the rgb branch's hidden layers in forward
// order (rgb_h with view dirs; r0, rgb_h without), width max(hid, last). A
// recorded byte is 1 (positive slope) or 0 (alpha); what is not recorded (a
// layer's columns past its width, rows past the call's) keeps the caller's
// fill. At the flagship fine pass (4096 rays x 128 samples, hid 256) that is
// 9 x 524,288 x 256 bytes, 1.2 GB: a check's buffer, never the training
// step's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_br {

struct NoBranches {
  static __device__ __forceinline__ void tile(int, int, int, int, int) {}
  static __device__ __forceinline__ void record(int, int, int, bool) {}
  static __device__ __forceinline__ void record_pair(int, int, int, int, float2) {}
};

}  // namespace nerf_br

#ifdef NERF_BRANCHES

namespace nerf_br {

struct Mask {
  uint8_t* bytes;
  long long rows;
  int width;
};
__device__ Mask mask;
// The tile being walked: written by thread 0 before a barrier, read after it.
__shared__ long long tile_row0;
__shared__ int tile_rows;

struct RecordBranches {
  static __device__ __forceinline__ void tile(int a, int b, int j, int n, int bm) {
    if (threadIdx.x == 0) {
      tile_row0 = (long long)a * b + (long long)j * bm;
      tile_rows = min(bm, n - j * bm);
    }
  }
  static __device__ __forceinline__ void record(int layer, int r, int c, bool pos) {
    if (r < tile_rows)
      mask.bytes[((long long)layer * mask.rows + tile_row0 + r) * mask.width + c] = pos ? 1 : 0;
  }
  static __device__ __forceinline__ void record_pair(int layer, int r, int c, int N, float2 p) {
    if (c < N) record(layer, r, c, p.x >= 0.f);
    if (c + 1 < N) record(layer, r, c + 1, p.y >= 0.f);
  }
};
using Sink = RecordBranches;

}  // namespace nerf_br

// The mask the next launches on `stream` record into (see above).
extern "C" int nerf_branch_buffer(void* bytes, long long rows, int width, void* stream) {
  const nerf_br::Mask m{static_cast<uint8_t*>(bytes), rows, width};
  return (int)cudaMemcpyToSymbolAsync(nerf_br::mask, &m, sizeof(m), 0, cudaMemcpyHostToDevice,
                                      static_cast<cudaStream_t>(stream));
}

#else

namespace nerf_br {
using Sink = NoBranches;
}  // namespace nerf_br

#endif
