// The second launch of every backward and the export that sizes its slabs:
// each block of a backward kernel sums its share of the weight and bias
// gradients into a slab of its own (one thread owns each entry, no atomics),
// and reduce_partials adds the slabs in block order, so two runs on the same
// inputs give bitwise-equal gradients.
#pragma once

#include "mlp_common.cuh"

namespace nerf_mlp {

// out[i] = sum over blocks b = 0, 1, ... of partial[b][i], in that order.
static __global__ void reduce_partials(const float* __restrict__ partial, int n_blocks,
                                       size_t p_total, float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < p_total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * p_total + i];
    out[i] = s;
  }
}

// Second launch of a backward: the block slabs summed in block order.
static inline int launch_reduce(const float* partial, int n_blocks, size_t p_total,
                                float* dparams, cudaStream_t stream) {
  const int red_blocks = (int)((p_total + 255) / 256);
  reduce_partials<<<red_blocks, 256, 0, stream>>>(partial, n_blocks, p_total, dparams);
  return (int)cudaGetLastError();
}

}  // namespace nerf_mlp

// Entries of a block's slab: the weight gradients, then the bias gradients.
// Every backward library exports it, so its wrapper sizes the scratch from the
// library it launches and the two cannot disagree.
extern "C" long long nerf_mlp_param_count(int has_dir, int xyz, int dir, int hid, int last) {
  const nerf_mlp::Dims dm{0, xyz, dir, hid, last, has_dir, 0.f};
  const nerf_mlp::Layout L = nerf_mlp::make_layout(dm);
  return (long long)L.total_w + L.total_b;
}
