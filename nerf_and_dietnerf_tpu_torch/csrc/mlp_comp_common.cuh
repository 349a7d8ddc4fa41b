// Shared device code of the MLP + compositing kernels on given encodings
// (B4: mlp_comp_fwd.cu, mlp_comp_bwd.cu; B5: mlp_loss_comp.cu).
//
// Rows are ray-major: row = ray * S + sample, the free reshape of a
// (rays, S, features) encoding array, so z (R, S) is indexed by the row. The
// xyz encodings arrive per row in the compute type; the view-dir encodings
// arrive per ray in f32 and are copied into every row of the ray's tile here,
// rounded to the compute type, so their per-sample broadcast never exists in
// global memory. A block owns whole rays (rays_per_group) and walks their rows
// in TM-row chunks.
#pragma once

#include "composite_common.cuh"
#include "mlp_common.cuh"

namespace nerf_comp {

// The encodings and depths of all rays.
template <typename T>
struct EncRays {
  const T* enc;       // (R * S, xyz) xyz encodings, ray-major rows
  const float* encd;  // (R, dir) per-ray view-dir encodings (unused without view dirs)
  const float* z;     // (R, S) sample depths
  int R, S;
};

// The rows a block owns in one step: rays [ray0, ray0 + n_rays).
struct Group {
  int ray0, n_rays, rows;
};

__device__ inline Group group_of(int group, int R, int S) {
  const int rpg = rays_per_group(S);
  Group g;
  g.ray0 = group * rpg;
  g.n_rays = min(rpg, R - g.ray0);
  g.rows = g.n_rays * S;
  return g;
}

// The X (TM x XMAX) and D (TM x DMAX) tiles of the group's rows
// [c0, c0 + TM); rows at or past g.rows are zero.
template <typename T>
__device__ void load_chunk(const EncRays<T>& in, const Dims& dm, const Group& g, int c0, float* X,
                           float* D) {
  const size_t grow0 = (size_t)g.ray0 * in.S;
  for (int idx = threadIdx.x; idx < TM * dm.xyz; idx += NT) {
    const int r = idx / dm.xyz, c = idx % dm.xyz, row = c0 + r;
    X[r * XMAX + c] = row < g.rows ? to_f<T>(in.enc[(grow0 + row) * dm.xyz + c]) : 0.f;
  }
  if (!dm.has_dir) return;
  for (int idx = threadIdx.x; idx < TM * dm.dir; idx += NT) {
    const int r = idx / dm.dir, c = idx % dm.dir, row = c0 + r;
    D[r * DMAX + c] =
        row < g.rows ? round_t<T>(in.encd[(size_t)(g.ray0 + row / in.S) * dm.dir + c]) : 0.f;
  }
}

// Number of ray groups of (R, S), or 0 where S is not a count the kernels take.
inline int n_groups(int R, int S) {
  if (S <= 0 || S > MAX_S_COMP) return 0;
  const int rpg = rays_per_group(S);
  return (R + rpg - 1) / rpg;
}

// TM-row chunks of one group.
__host__ __device__ inline int chunks_per_group(int S) { return (rays_per_group(S) * S + TM - 1) / TM; }

}  // namespace nerf_comp

// Sizes a wrapper needs: the ray groups the blocks walk, and the activation
// slots (elements of the compute type) a backward block keeps for one group.
// Every library of the family exports them, so a wrapper sizes its scratch
// from the library it launches.
extern "C" int nerf_mlp_comp_groups(int R, int S) { return nerf_comp::n_groups(R, S); }
extern "C" long long nerf_mlp_comp_act_slots(int S) {
  return (long long)nerf_comp::chunks_per_group(S) * nerf_mlp::NACT * nerf_mlp::TM * nerf_mlp::HMAX;
}
