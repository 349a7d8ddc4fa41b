// Shared device code of the MLP + compositing kernels on given encodings
// (B4: mlp_comp_fwd.cu, mlp_comp_bwd.cu; B5: mlp_loss_comp.cu).
//
// Rows are ray-major: row = ray * S + sample, the free reshape of a
// (rays, S, features) encoding array, so z (R, S) is indexed by the row. The
// xyz encodings arrive per row in the compute type; the view-dir encodings
// arrive per ray in f32 and are copied into every row of the ray's tile here,
// rounded to the compute type (the f32 tiles copy them exactly), so their
// per-sample broadcast never exists in global memory. f32 B4's forward (the
// FMA tile) walks a block's whole rays in TM-row chunks (load_chunk); the
// bf16 kernels run the ray-group loop of comp_mma_tile.cuh on 128-row
// tensor-core tiles (load_comp_mma_inputs), f32 B5 and B4's backward on the
// f32 kit's 64-row tiles (load_comp_t32_inputs).
#pragma once

#include "comp_mma_tile.cuh"
#include "composite_common.cuh"
#include "mlp_common.cuh"
#include "mlp_tf32_mma_tile.cuh"

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

// The X (BM x LDX) and D (BM x LDD) bf16 tiles of the group's rows [r0, r0 +
// BM) for the ray-group loop: the xyz encodings' bf16 rows copied, each
// ray's f32 view-dir encoding rounded to bf16 into every row of the ray (as
// load_chunk); rows at or past g.rows and the pad columns zero.
__device__ inline void load_comp_mma_inputs(const EncRays<nerf_mma::bf16>& in, const Dims& dm,
                                            const nerf_cmma::Group& g, int r0, nerf_mma::bf16* X,
                                            nerf_mma::bf16* D) {
  nerf_mma::load_tile(X, nerf_mma::LDX, in.enc + (size_t)g.ray0 * in.S * dm.xyz, dm.xyz, r0,
                      g.rows);
  if (!dm.has_dir) return;
  const int dp = nerf_mma::pad16(dm.dir);
  for (int i = threadIdx.x; i < nerf_mma::BM * dp; i += nerf_mma::NT) {
    const int r = i / dp, c = i - r * dp, row = r0 + r;
    D[r * nerf_mma::LDD + c] = __float2bfloat16_rn(
        row < g.rows && c < dm.dir ? in.encd[(size_t)(g.ray0 + row / in.S) * dm.dir + c] : 0.f);
  }
}

// The f32 X (BM x LDX) and D (BM x LDD) tiles of mlp_tf32_mma_tile.cuh for
// the group's rows [r0, r0 + BM): the xyz encodings' f32 rows and each ray's
// f32 view-dir encoding copied exactly into every row of the ray, stored
// swizzled; rows at or past g.rows and the pad columns (to pad16) zero.
__device__ inline void load_comp_t32_inputs(const EncRays<float>& in, const Dims& dm,
                                            const nerf_cmma::Group& g, int r0, float* X,
                                            float* D) {
  namespace tm = nerf_tmma;
  tm::load_rows(X, tm::LDX, in.enc + (size_t)g.ray0 * in.S * dm.xyz, dm.xyz, r0, g.rows);
  if (!dm.has_dir) return;
  const int dp = nerf_mma::pad16(dm.dir);
  for (int i = threadIdx.x; i < tm::BM * dp; i += tm::NT) {
    const int r = i / dp, c = i - r * dp, row = r0 + r;
    D[r * tm::LDD + tm::sw(r, c)] =
        row < g.rows && c < dm.dir ? in.encd[(size_t)(g.ray0 + row / in.S) * dm.dir + c] : 0.f;
  }
}

}  // namespace nerf_comp
