// Shared device code of the kernels that composite in the kernel (B7:
// raymarch_comp_fwd.cu, raymarch_comp_bwd.cu; B4: mlp_comp_fwd.cu,
// mlp_comp_bwd.cu; B5: mlp_loss_comp.cu): alpha compositing of one ray and its
// VJP, serial over the ray's samples. The grouping of whole rays into a
// block's tiles is comp_mma_tile.cuh's.
#pragma once

#include "mlp_common.cuh"

namespace nerf_comp {

using namespace nerf_mlp;

constexpr float TERMINAL_DELTA = 1e9f;
constexpr int MAX_S_COMP = 512;  // samples per ray the compositing kernels take

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

// VJP of composite_ray for the cotangents g_rgb (3) and g_w (S; null: zero):
// the raw cotangent g_raw (S, 4, stride 4) and compositing's share of dz (S).
// The transmittance chain runs as the reverse affine recurrence
//   C_s = gW_s * a_s + (1 - a_s) * C_{s+1},  da_s = (gW_s - C_{s+1}) * T_s,
// with no division, so rays whose transmittance underflows to 0 stay finite.
// It is the derivative of the forward as computed: the chain uses the rounded
// 1 - a_s that the forward multiplied into T, and d a_s / d(sigma delta) is
// e_s = exp(-sigma delta) itself, which 1 - a_s rounds to 0 once a_s is within
// 2^-25 of 1. g_raw's sigma column and dz hold e and T between the two sweeps.
__device__ inline void composite_ray_bwd(const float* raw, const float* z, int S,
                                         const float* g_rgb, const float* g_w, float* g_raw,
                                         float* dz) {
  float T = 1.f;
  for (int s = 0; s < S; ++s) {
    const float sigma = fmaxf(raw[4 * s + 3], 0.f);
    const float e = expf(-sigma * delta_of(z, s, S));
    const float alpha = 1.f - e;
    g_raw[4 * s + 3] = e;
    dz[s] = T;
    T *= 1.f - alpha;
  }
  float c_next = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const float e = g_raw[4 * s + 3], alpha = 1.f - e, Ts = dz[s];
    const float pre = raw[4 * s + 3], sigma = fmaxf(pre, 0.f);
    const float delta = delta_of(z, s, S);
    const float w = alpha * Ts;
    float c[3], gw = 0.f;
    for (int ch = 0; ch < 3; ++ch) {
      c[ch] = sigmoid(raw[4 * s + ch]);
      gw += c[ch] * g_rgb[ch];
    }
    gw = (g_w ? g_w[s] : 0.f) + gw;
    const float da = (gw - c_next) * Ts;
    c_next = gw * alpha + (1.f - alpha) * c_next;
    for (int ch = 0; ch < 3; ++ch) g_raw[4 * s + ch] = ((w * g_rgb[ch]) * c[ch]) * (1.f - c[ch]);
    g_raw[4 * s + 3] = pre > 0.f ? da * delta * e : 0.f;
    const float dd = s < S - 1 ? da * sigma * e : 0.f;
    dz[s] = -dd;              // delta_s = z_{s+1} - z_s
    if (s < S - 1) dz[s + 1] += dd;
  }
}

}  // namespace nerf_comp
