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
#pragma once

#include "mlp_common.cuh"

namespace nerf_rm {

using namespace nerf_mlp;

constexpr float PI_F = 3.14159265358979f;
constexpr float TERMINAL_DELTA = 1e9f;
constexpr int MAX_S_COMP = 512;  // samples per ray the compositing kernels take

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
// rounded to the compute type; rows at or past `row_end` are zero.
template <typename T>
__device__ void build_inputs(const Rays& ry, int xyz, int dir, int row0, int row_end, float* X,
                             float* Dt) {
  const int per = 1 + 2 * ry.L;
  for (int idx = threadIdx.x; idx < TM * xyz; idx += NT) {
    const int r = idx / xyz, c = idx % xyz, row = row0 + r;
    float v = 0.f;
    if (row < row_end) {
      const float* ray = ry.rd + (size_t)(row / ry.S) * (6 + ry.D);
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
      const float* ray = ry.rd + (size_t)(row / ry.S) * (6 + ry.D);
      const int j = c % perd;
      v = sinf(enc_theta(ray[6 + c / perd], j >> 1, j & 1));
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

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float delta_of(const float* z, int s, int S) {
  return s < S - 1 ? z[s + 1] - z[s] : TERMINAL_DELTA;
}

// Alpha compositing of one ray (core/rendering.composite): raw (S, 4) with
// stride 4, z (S); writes rgb (3) and weights (S). Serial over samples, so
// the transmittance is the same running product as a serial cumprod.
__device__ inline void composite_ray(const float* raw, const float* z, int S, float* rgb,
                                     float* weights) {
  float T = 1.f, acc[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const float sigma = fmaxf(raw[4 * s + 3], 0.f);
    const float alpha = 1.f - expf(-sigma * delta_of(z, s, S));
    const float w = alpha * T;
    weights[s] = w;
    for (int ch = 0; ch < 3; ++ch) acc[ch] += w * sigmoid(raw[4 * s + ch]);
    T *= 1.f - alpha;
  }
  for (int ch = 0; ch < 3; ++ch) rgb[ch] = acc[ch];
}

// VJP of composite_ray for the cotangents g_rgb (3) and g_w (S): the raw
// cotangent g_raw (S, 4, stride 4) and compositing's share of dz (S). The
// transmittance chain runs as the reverse affine recurrence
//   C_s = gW_s * a_s + (1 - a_s) * C_{s+1},  da_s = (gW_s - C_{s+1}) * T_s,
// with no division, so rays whose transmittance underflows to 0 stay finite.
// g_raw's sigma column and dz hold alpha and T between the two sweeps.
__device__ inline void composite_ray_bwd(const float* raw, const float* z, int S,
                                         const float* g_rgb, const float* g_w, float* g_raw,
                                         float* dz) {
  float T = 1.f;
  for (int s = 0; s < S; ++s) {
    const float sigma = fmaxf(raw[4 * s + 3], 0.f);
    const float alpha = 1.f - expf(-sigma * delta_of(z, s, S));
    g_raw[4 * s + 3] = alpha;
    dz[s] = T;
    T *= 1.f - alpha;
  }
  float c_next = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const float alpha = g_raw[4 * s + 3], Ts = dz[s];
    const float pre = raw[4 * s + 3], sigma = fmaxf(pre, 0.f);
    const float delta = delta_of(z, s, S);
    const float w = alpha * Ts;
    float c[3], gw = 0.f;
    for (int ch = 0; ch < 3; ++ch) {
      c[ch] = sigmoid(raw[4 * s + ch]);
      gw += c[ch] * g_rgb[ch];
    }
    gw = g_w[s] + gw;
    const float om = 1.f - alpha;
    const float da = (gw - c_next) * Ts;
    c_next = gw * alpha + om * c_next;
    for (int ch = 0; ch < 3; ++ch) g_raw[4 * s + ch] = ((w * g_rgb[ch]) * c[ch]) * (1.f - c[ch]);
    g_raw[4 * s + 3] = pre > 0.f ? da * delta * om : 0.f;
    const float dd = s < S - 1 ? da * sigma * om : 0.f;
    dz[s] = -dd;              // delta_s = z_{s+1} - z_s
    if (s < S - 1) dz[s + 1] += dd;
  }
}

// Rays per group of the compositing kernels: whole rays, about TM rows.
__host__ __device__ inline int rays_per_group(int S) { return S >= TM ? 1 : TM / S; }

}  // namespace nerf_rm
