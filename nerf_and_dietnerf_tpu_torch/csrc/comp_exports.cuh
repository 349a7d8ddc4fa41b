// Scratch sizes of the compositing backwards (B7: raymarch_comp_bwd.cu; B5:
// mlp_loss_comp.cu; B4: mlp_comp_bwd.cu), by compute type. Each of the three
// libraries includes this header, so a wrapper sizes the scratch from the
// library it launches and the two cannot disagree. bf16: the ray-group loop
// of comp_mma_tile.cuh (whole rays in one 128-row tile, every tile's slots,
// a BM-row f32 slab a block). f32: groups of about 64 rows (the FMA kernels'
// chunks, and the 64-row tiles of f32 B7's and B5's tensor-core loop); the library
// defines how many 64-row chunks' slots its f32 kernel keeps for a group
// (f32_chunks_kept) and the rows of its f32 slab (f32_slab_rows: B7's and
// B5's dx rows, none for B4's FMA kernel).
#pragma once

#include "comp_mma_tile.cuh"

namespace nerf_comp {
int f32_chunks_kept(int S);  // each library's own
int f32_slab_rows();         // each library's own
}  // namespace nerf_comp

// Ray groups the kernel of the compute type walks, 0 where S is not a count
// it takes.
extern "C" int nerf_comp_groups(int is_bf16, int R, int S) {
  return is_bf16 ? nerf_cmma::n_groups(R, S) : nerf_comp::n_groups(R, S);
}
// Activation-slot elements of the compute type a block keeps for a group.
extern "C" long long nerf_comp_act_elems(int is_bf16, int S) {
  return is_bf16 ? nerf_cmma::act_elems(S)
                 : (long long)nerf_comp::f32_chunks_kept(S) * nerf_mlp::NACT * nerf_mlp::TM *
                       nerf_mlp::HMAX;
}
// Rows of a block's f32 slab (dx or dd rows) for the compute type.
extern "C" int nerf_comp_dx_rows(int is_bf16) {
  return is_bf16 ? nerf_mma::BM : nerf_comp::f32_slab_rows();
}
