// Shared device code of the MLP + compositing kernels on given encodings
// (B4: mlp_comp_fwd.cu, mlp_comp_bwd.cu; B5: mlp_loss_comp.cu).
//
// Rows are ray-major: row = ray * S + sample, the free reshape of a
// (rays, S, features) encoding array, so z (R, S) is indexed by the row. The
// xyz encodings arrive per row in the compute type; the view-dir encodings
// arrive per ray in f32 and are copied into every row of the ray's tile here,
// rounded to the compute type (the f32 tiles copy them exactly), so their
// per-sample broadcast never exists in global memory. Every kernel runs the
// ray-group loops of comp_mma_tile.cuh: in bf16 on 128-row tensor-core tiles
// (load_comp_mma_inputs), in f32 on the f32 kit's 64-row tiles
// (load_comp_t32_inputs).
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

// The X (BM x LDX) and D (BM x LDD) bf16 tiles of the group's rows [r0, r0 +
// BM) for the ray-group loop: the xyz encodings' bf16 rows copied, each
// ray's f32 view-dir encoding rounded to bf16 into every row of the ray;
// rows at or past g.rows and the pad columns zero.
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
