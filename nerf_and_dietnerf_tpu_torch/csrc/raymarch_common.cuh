// Shared device code of the fused ray-march kernels (B6: raymarch_fwd.cu,
// raymarch_bwd.cu; B7: raymarch_comp_fwd.cu, raymarch_comp_bwd.cu).
//
// Rows are ray-major: row = ray * S + sample, so z (R, S) row-major is indexed
// by the row itself. A row's point is o + z * d; its encodings are built here,
// in the reference's coordinate-major column order (the order of
// core/encoding.py, so the MLP kernels' weight layout is reused unchanged),
// with what the TPU kernel computes (`_encode_tile` in
// nerf_and_dietnerf_tpu/ops/research_kernels.py): theta = f_k * v, plus pi/2
// for a cos column, f_k = float(pi) * 2^k, and a direct sin(theta). The
// products and sums are rounded one by one (no contraction into an FMA), as
// the plain PyTorch version computes them, and sinf / cosf are the full-range
// library functions: theta reaches hundreds of radians for far points.
// B7's per-ray compositing and its VJP are in composite_common.cuh, which the
// MLP + compositing kernels (B4, B5) share.
#pragma once

#include "composite_common.cuh"

namespace nerf_rm {

using namespace nerf_mlp;
using namespace nerf_comp;

constexpr float PI_F = 3.14159265358979f;

struct Rays {
  const float* rd;  // (R, 6 + D): origin xyz | direction xyz | view components
  const float* z;   // (R, S) sample depths
  int R, S;
  int L;   // xyz octaves
  int Ld;  // view-dir octaves
  int D;   // view components (0: xyz-only variant)
};

__device__ __forceinline__ float freq(int k) { return ldexpf(PI_F, k); }

__device__ __forceinline__ float enc_theta(float v, int k, int is_cos) {
  const float t = __fmul_rn(v, freq(k));
  return is_cos ? __fadd_rn(t, 0.5f * PI_F) : t;
}

__device__ __forceinline__ float point(const float* ray, float z, int c) {
  return __fadd_rn(ray[c], __fmul_rn(z, ray[3 + c]));
}

// The X (TM x XMAX) and D (TM x DMAX) tiles of rows [row0, row0 + TM),
// rounded to the compute type; rows at or past `row_end` are zero. Since the
// tensor-core tiles build their own (raymarch_tile.cuh), only f32 B6's
// forward at widths over its 64 input columns runs this.
template <typename T>
__device__ void build_inputs(const Rays& ry, int xyz, int dir, int row0, int row_end, float* X,
                             float* Dt) {
  const int width = 6 + ry.D;
  const int per = 1 + 2 * ry.L;
  for (int idx = threadIdx.x; idx < TM * xyz; idx += NT) {
    const int r = idx / xyz, c = idx % xyz, row = row0 + r;
    float v = 0.f;
    if (row < row_end) {
      const float* ray = ry.rd + (size_t)(row / ry.S) * width;
      const int j = c % per;
      const float p = point(ray, ry.z[row], c / per);
      v = j == 0 ? p : sinf(enc_theta(p, (j - 1) >> 1, (j - 1) & 1));
    }
    X[r * XMAX + c] = round_t<T>(v);
  }
  if (ry.D == 0) return;
  const int perd = 2 * ry.Ld;
  for (int idx = threadIdx.x; idx < TM * dir; idx += NT) {
    const int r = idx / dir, c = idx % dir, row = row0 + r;
    float v = 0.f;
    if (row < row_end) {
      const int ray_i = row / ry.S;
      const int j = c % perd;
      v = sinf(enc_theta(ry.rd[(size_t)ray_i * width + 6 + c / perd], j >> 1, j & 1));
    }
    Dt[r * DMAX + c] = round_t<T>(v);
  }
}

// dz of one row from its xyz-encoding cotangent gx (row of a GX tile): the
// encoding VJP dtheta = g * cos(theta) (theta with its pi/2 offsets), then
// dpts_c = sum_k f_k * dtheta + g[identity c], then dz = dpts . d. The view
// components' cotangent is dropped (structural zero, as on the TPU).
__device__ inline float dz_of_row(const Rays& ry, const float* gx, int row) {
  const float* ray = ry.rd + (size_t)(row / ry.S) * (6 + ry.D);
  const float z = ry.z[row];
  const int per = 1 + 2 * ry.L;
  float dz = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float p = point(ray, z, c);
    const float* g = gx + c * per;
    float s = 0.f;
    for (int k = 0; k < ry.L; ++k) {
      const float f = freq(k);
      s += __fmul_rn(__fmul_rn(g[1 + 2 * k], cosf(enc_theta(p, k, 0))), f);
      s += __fmul_rn(__fmul_rn(g[2 + 2 * k], cosf(enc_theta(p, k, 1))), f);
    }
    dz += __fmul_rn(s + g[0], ray[3 + c]);
  }
  return dz;
}

}  // namespace nerf_rm
