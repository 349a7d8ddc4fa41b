// The inputs of B7's ray-group loops (raymarch_comp_fwd.cu, raymarch_comp_bwd.cu
// on comp_mma_tile.cuh): each row's features built straight into the operand
// tiles of the kit the loop runs, as B6 builds them (raymarch_tile.cuh), so
// the (R S, xyz) and (R S, dir) encodings never reach device memory. The
// forward and the backward share them, so the two build the same tiles.
#pragma once

#include "comp_mma_tile.cuh"
#include "raymarch_tile.cuh"

static_assert(nerf_cmma::max_smem_bytes<nerf_tmma::Kit>() ==
                      nerf_cmma::smem_bytes<nerf_tmma::Kit>(nerf_comp::MAX_S_COMP) &&
                  nerf_cmma::smem_bytes<nerf_tmma::Kit>(nerf_comp::MAX_S_COMP) == 217348 &&
                  nerf_cmma::smem_bytes<nerf_tmma::Kit>(64) == 201220,
              "the group's rows beside the f32 backward tiles (comp_mma_tile.cuh)");
static_assert(nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(64) == 130304 &&
                  nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(32) == 130304 &&
                  nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(128) == 131328 &&
                  nerf_cmma::fwd_smem_bytes<nerf_tmma::Kit>(nerf_comp::MAX_S_COMP) == 137472,
              "the group's raw values beside the f32 forward tiles (comp_mma_tile.cuh)");

namespace nerf_rm {

// The `inputs` of B7's policies: the group's rows [r0, r0 + BM) of the rays,
// in the tiles of either kit (bf16: build_mma_inputs; f32: build_t32_inputs;
// both in raymarch_tile.cuh).
struct RayGroupInputs {
  Rays ry;
  int xyz, dir;

  __device__ void inputs(const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                         nerf_mma::bf16* D) const {
    const int grow0 = g.ray0 * ry.S;
    build_mma_inputs(ry, xyz, dir, grow0 + r0, grow0 + g.rows, X, D);
  }
  __device__ void inputs(const nerf_cmma::Group& g, int r0, float* X, float* D) const {
    const int grow0 = g.ray0 * ry.S;
    build_t32_inputs(ry, xyz, dir, grow0 + r0, grow0 + g.rows, X, D);
  }
};

}  // namespace nerf_rm
