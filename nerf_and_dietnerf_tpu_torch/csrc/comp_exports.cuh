// Scratch sizes of the compositing backwards (B7: raymarch_comp_bwd.cu; B5:
// mlp_loss_comp.cu; B4: mlp_comp_bwd.cu), by compute type. Each of the three
// libraries includes this header, so a wrapper sizes the scratch from the
// library it launches and the two cannot disagree. Both types run the
// ray-group loop of comp_mma_tile.cuh: bf16 on the 128-row tiles of Bf16Kit,
// f32 on the 64-row tiles of nerf_tmma::Kit. A block keeps every tile's
// slots of its group and a BM-row f32 slab (B7's and B5's dx rows, B4's dd
// rows).
#pragma once

#include "comp_mma_tile.cuh"
#include "mlp_tf32_mma_tile.cuh"

static_assert(nerf_cmma::max_smem_bytes<nerf_tmma::Kit>() <= 232448,
              "the f32 group's rows must fit beside the f32 backward tiles");

// Ray groups the kernel of the compute type walks, 0 where S is not a count
// it takes.
extern "C" int nerf_comp_groups(int is_bf16, int R, int S) {
  return is_bf16 ? nerf_cmma::n_groups(R, S) : nerf_cmma::n_groups(R, S, nerf_tmma::BM);
}
// Activation-slot elements of the compute type a block keeps for a group.
extern "C" long long nerf_comp_act_elems(int is_bf16, int S) {
  return is_bf16 ? nerf_cmma::act_elems(S) : nerf_cmma::act_elems<nerf_tmma::Kit>(S);
}
// Rows of a block's f32 slab (dx or dd rows) for the compute type.
extern "C" int nerf_comp_dx_rows(int is_bf16) { return is_bf16 ? nerf_mma::BM : nerf_tmma::BM; }
