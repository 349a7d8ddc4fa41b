// Shared device code of the f32 FMA backwards (f32 B6, raymarch_bwd.cu, and
// f32 B4, mlp_comp_bwd.cu) and the slab sum and scratch exports every
// backward library uses: one 64-row tile's forward with its activations kept
// (`backward_tile` recomputes it; the compositing kernel ran it already and
// calls `backward_walk`), then the chain back, with the weight and bias
// gradients summed into the block's own slab of a scratch buffer.
//
// As the JAX package's `_backward_tile`: the leaky gradient takes the sign of
// the post-activation (ties >= 0 take the identity branch), gradients are
// rounded to the compute type before each product, the rgb/sigma output
// cotangents enter the weight products in f32.
#pragma once

#include "mlp_common.cuh"

namespace nerf_mlp {

// dst (K, N) row-major (+)= A^T @ G over the tile's TM rows.
// A: (TM, K) float tile, row stride lda; G: (TM, N) float tile, row stride ldg.
__device__ inline void wgrad(float* __restrict__ dst, const float* A, int lda, const float* G,
                             int ldg, int K, int N, bool first) {
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  if (N <= 8) {  // narrow heads: one entry per thread
    for (int e = tid; e < K * N; e += NT) {
      const int k = e / N, nn = e % N;
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s = fmaf(A[r * lda + k], G[r * ldg + nn], s);
      dst[e] = first ? s : dst[e] + s;
    }
    return;
  }
  // A warp owns 8 rows of dst and columns lane + 32 * j of them.
  for (int k0 = wp * 8; k0 < K; k0 += 64) {
    float s[8][8];
    zero_acc(s);
    for (int r = 0; r < TM; ++r) {
      float a[8], g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[r * lda + k0 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j] = G[r * ldg + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], g[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = lane + 32 * j;
        if (k < K && n < N) {
          const size_t e = (size_t)k * N + n;
          dst[e] = first ? s[i][j] : dst[e] + s[i][j];
        }
      }
    }
  }
}

// dst (N) (+)= column sums of G (TM, N).
__device__ inline void bgrad(float* __restrict__ dst, const float* G, int ldg, int N, bool first) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += G[r * ldg + n];
    dst[n] = first ? s : dst[n] + s;
  }
}

// Float copy of a kept activation slot (the first `width` columns).
template <typename T>
__device__ void load_act(float* dst, const T* slot, int width) {
  for (int idx = threadIdx.x; idx < TM * width; idx += NT) {
    const int r = idx / width, c = idx % width;
    dst[r * HMAX + c] = to_f<T>(slot[r * HMAX + c]);
  }
}

// Head chain: G = leaky'(post) * round_T(acc), with the slope rounded to T
// and the product rounded to T, as the reference does on compute-type values.
// post: (TM, N) float tile (row stride HMAX).
template <typename T>
__device__ void head_grad(const float (&acc)[8][8], const float* post, int N, float alpha,
                          float* G) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float alpha_t = round_t<T>(alpha);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = acc_col(tx, j);
      if (n < N) {
        const float t = round_t<T>(acc[i][j]);
        G[r * HMAX + n] = post[r * HMAX + n] >= 0.f ? t : round_t<T>(alpha_t * t);
      }
    }
  }
}

// Trunk chain: G = round_T(leaky'(post) * acc) with the f32 slope.
template <typename T>
__device__ void trunk_grad(const float (&acc)[8][8], const T* post, int N, float alpha,
                           float* G) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = acc_col(tx, j);
      if (n < N) {
        const float g = acc[i][j];
        G[r * HMAX + n] = round_t<T>(to_f<T>(post[r * HMAX + n]) >= 0.f ? g : alpha * g);
      }
    }
  }
}

// Rows of acc (+ add, if given) into a global (n, N) f32 array.
__device__ inline void store_rows(const float (&acc)[8][8], const float* add, int ld_add, int N,
                                  float* dst, int row0, int n) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (row0 + r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      if (c < N) {
        float v = acc[i][j];
        if (add) v += add[r * ld_add + c];
        dst[(size_t)(row0 + r) * N + c] = v;
      }
    }
  }
}

// GI (TM, 8) from the (n, 4) f32 cotangent rows [row0, row0 + TM):
// grgb f32 | gsig f32 | gsig rounded to T; rows past n are zero.
template <typename T>
__device__ void load_cotangent(float* GI, const float* __restrict__ g, int row0, int n) {
  for (int idx = threadIdx.x; idx < TM * 4; idx += NT) {
    const int r = idx >> 2, c = idx & 3;
    const float v = row0 + r < n ? g[(size_t)(row0 + r) * 4 + c] : 0.f;
    GI[r * 8 + c] = v;
    if (c == 3) GI[r * 8 + 4] = round_t<T>(v);
  }
}

// Shared-memory tiles of the backward (see bwd_smem_bytes).
struct BwdTiles {
  float* P;   // activations / forward ping buffer (TM x HMAX)
  float* G;   // gradient tile / forward pong buffer (TM x HMAX)
  float* Ws;  // streamed weight chunk (KC x HMAX)
  float* X;   // encoded xyz (TM x XMAX)
  float* D;   // encoded view dirs (TM x DMAX); with dd_in_D, the tile's dd rows afterwards
  float* GX;  // skip layer's share of dx, then (with dx == nullptr) all of dx (TM x XMAX)
  float* GI;  // output cotangent (TM x 8), see load_cotangent
  bool dd_in_D;  // leave the view-dir gradient rows on chip, in D (see backward_walk)
};

__device__ inline BwdTiles bwd_tiles(float* smem) {
  BwdTiles t;
  t.P = smem;
  t.G = t.P + TM * HMAX;
  t.Ws = t.G + TM * HMAX;
  t.X = t.Ws + KC * HMAX;
  t.D = t.X + TM * XMAX;
  t.GX = t.D + TM * DMAX;
  t.GI = t.GX + TM * XMAX;
  t.dd_in_D = false;
  return t;
}

// The chain back over one tile whose X, D and GI tiles are loaded (and a
// barrier passed) and whose forward left its post-activations in `acts` (NACT
// slots, as forward_tile keeps them). Weight and bias gradients go to `part`
// (the block's slab: weights, then biases), written on the block's first tile
// and added to after. dx / dd rows go to global memory where given. A null dx
// leaves the tile's whole dx in t.GX (after a barrier). A null dd skips the
// view-dir gradient, unless t.dd_in_D: then its rows replace t.D, whose last
// readers are the head's weight-gradient products (rows past dm.n hold 0).
template <typename T>
__device__ void backward_walk(const Dims& dm, const Layout& L, const T* __restrict__ W,
                              const T* __restrict__ WT, const float* __restrict__ B,
                              const BwdTiles& t, const T* acts, float* part, bool first,
                              int row0, float* dx, float* dd) {
  float* pb = part + L.total_w;
  auto slot = [&](int s) { return acts + (size_t)s * TM * HMAX; };
  const float alpha = dm.alpha;
  float* P = t.P;
  float* G = t.G;
  float* Ws = t.Ws;
  const float* X = t.X;
  const float* D = t.D;
  float* GX = t.GX;
  const float* GI = t.GI;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  float acc[8][8];

  if (dm.has_dir) {
    // rgb_out: (last, 3)
    load_act<T>(P, slot(8), dm.last);
    __syncthreads();
    wgrad(part + L.w[11], P, HMAX, GI, 8, dm.last, 3, first);
    bgrad(pb + L.b[9], GI, 8, 3, first);
    zero_acc(acc);
    gemm_acc<T>(acc, GI, 8, 3, WT + L.w[11], dm.last, Ws);
    head_grad<T>(acc, P, dm.last, alpha, G);  // g_rgb_h
    __syncthreads();
    // rgb_hidden over [h8, d] and sigma_out over [h8, d]
    load_act<T>(P, slot(N_TRUNK - 1), dm.hid);
    __syncthreads();
    wgrad(part + L.w[9], P, HMAX, G, HMAX, dm.hid, dm.last, first);
    wgrad(part + L.w[10], D, DMAX, G, HMAX, dm.dir, dm.last, first);
    bgrad(pb + L.b[8], G, HMAX, dm.last, first);
    wgrad(part + L.w[12], P, HMAX, GI + 3, 8, dm.hid, 1, first);
    wgrad(part + L.w[13], D, DMAX, GI + 3, 8, dm.dir, 1, first);
    bgrad(pb + L.b[10], GI + 3, 8, 1, first);
    if (dd || t.dd_in_D) {
      // dd = g_rgb_h @ Wrh_d^T + gsig @ Wsig_d^T
      zero_acc(acc);
      gemm_acc<T>(acc, G, HMAX, dm.last, WT + L.w[10], dm.dir, Ws);
      gemm_acc<T>(acc, GI + 4, 8, 1, WT + L.w[13], dm.dir, Ws);
      if (dd) {
        store_rows(acc, nullptr, 0, dm.dir, dd, row0, dm.n);
      } else {
        // The barrier that ends gemm_acc lies behind every read of D above.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = acc_col(tx, j);
            if (c < dm.dir) t.D[(ty * 8 + i) * DMAX + c] = acc[i][j];
          }
      }
    }
    // g_h8 = g_rgb_h @ Wrh_h^T + gsig @ Wsig_h^T
    zero_acc(acc);
    gemm_acc<T>(acc, G, HMAX, dm.last, WT + L.w[9], dm.hid, Ws);
    gemm_acc<T>(acc, GI + 4, 8, 1, WT + L.w[12], dm.hid, Ws);
  } else {
    // rgb_out: (last, 3)
    load_act<T>(P, slot(9), dm.last);
    __syncthreads();
    wgrad(part + L.w[11], P, HMAX, GI, 8, dm.last, 3, first);
    bgrad(pb + L.b[10], GI, 8, 3, first);
    zero_acc(acc);
    gemm_acc<T>(acc, GI, 8, 3, WT + L.w[11], dm.last, Ws);
    head_grad<T>(acc, P, dm.last, alpha, G);  // g_rgb_h
    __syncthreads();
    // rgb_hidden: (hid, last) over r0
    load_act<T>(P, slot(8), dm.hid);
    __syncthreads();
    wgrad(part + L.w[10], P, HMAX, G, HMAX, dm.hid, dm.last, first);
    bgrad(pb + L.b[9], G, HMAX, dm.last, first);
    zero_acc(acc);
    gemm_acc<T>(acc, G, HMAX, dm.last, WT + L.w[10], dm.hid, Ws);
    head_grad<T>(acc, P, dm.hid, alpha, G);  // g_r0
    __syncthreads();
    // rgb_hidden0 (hid, hid) and sigma_out (hid, 1) over h8
    load_act<T>(P, slot(N_TRUNK - 1), dm.hid);
    __syncthreads();
    wgrad(part + L.w[9], P, HMAX, G, HMAX, dm.hid, dm.hid, first);
    bgrad(pb + L.b[8], G, HMAX, dm.hid, first);
    wgrad(part + L.w[12], P, HMAX, GI + 3, 8, dm.hid, 1, first);
    bgrad(pb + L.b[11], GI + 3, 8, 1, first);
    // g_h8 = g_r0 @ Wrh0^T + gsig @ Wsig^T
    zero_acc(acc);
    gemm_acc<T>(acc, G, HMAX, dm.hid, WT + L.w[9], dm.hid, Ws);
    gemm_acc<T>(acc, GI + 4, 8, 1, WT + L.w[12], dm.hid, Ws);
  }

  // Trunk, reversed; acc holds the gradient of layer l's output.
  for (int l = N_TRUNK - 1; l >= 0; --l) {
    trunk_grad<T>(acc, slot(l), dm.hid, alpha, G);
    if (l > 0) load_act<T>(P, slot(l - 1), dm.hid);
    __syncthreads();
    bgrad(pb + L.b[l], G, HMAX, dm.hid, first);
    if (l == SKIP) {
      wgrad(part + L.w[SKIP], X, XMAX, G, HMAX, dm.xyz, dm.hid, first);
      wgrad(part + L.w[SKIP + 1], P, HMAX, G, HMAX, dm.hid, dm.hid, first);
      zero_acc(acc);
      gemm_acc<T>(acc, G, HMAX, dm.hid, WT + L.w[SKIP], dm.xyz, Ws);
      // keep the skip layer's share of dx in GX
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = acc_col(tx, j);
          if (c < dm.xyz) GX[(ty * 8 + i) * XMAX + c] = acc[i][j];
        }
      zero_acc(acc);
      gemm_acc<T>(acc, G, HMAX, dm.hid, WT + L.w[SKIP + 1], dm.hid, Ws);
    } else if (l > 0) {
      wgrad(part + L.w[trunk_w(l)], P, HMAX, G, HMAX, dm.hid, dm.hid, first);
      zero_acc(acc);
      gemm_acc<T>(acc, G, HMAX, dm.hid, WT + L.w[trunk_w(l)], dm.hid, Ws);
    } else {
      wgrad(part + L.w[0], X, XMAX, G, HMAX, dm.xyz, dm.hid, first);
      zero_acc(acc);
      gemm_acc<T>(acc, G, HMAX, dm.hid, WT + L.w[0], dm.xyz, Ws);
      if (dx) {
        store_rows(acc, GX, XMAX, dm.xyz, dx, row0, dm.n);
      } else {
        // Each thread adds to the GX entries it wrote at the skip layer.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = acc_col(tx, j);
            if (c < dm.xyz) GX[(ty * 8 + i) * XMAX + c] += acc[i][j];
          }
        __syncthreads();
      }
    }
  }
}

// The backward of one tile whose X, D and GI tiles are loaded (and a barrier
// passed): the forward recomputed into `acts` (the block's scratch slab of
// NACT activation slots), then backward_walk.
template <typename T>
__device__ void backward_tile(const Dims& dm, const Layout& L, const T* __restrict__ W,
                              const T* __restrict__ WT, const float* __restrict__ B,
                              const BwdTiles& t, T* acts, float* part, bool first, int row0,
                              float* dx, float* dd) {
  forward_tile<T>(dm, L, W, B, t.X, t.D, t.P, t.G, t.Ws, acts, nullptr, row0);
  __syncthreads();
  backward_walk<T>(dm, L, W, WT, B, t, acts, part, first, row0, dx, dd);
}

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
static inline int launch_reduce(const float* partial, int n_blocks, size_t p_total, float* dparams,
                         cudaStream_t stream) {
  const int red_blocks = (int)((p_total + 255) / 256);
  reduce_partials<<<red_blocks, 256, 0, stream>>>(partial, n_blocks, p_total, dparams);
  return (int)cudaGetLastError();
}

}  // namespace nerf_mlp

// Scratch sizes of a backward that runs this tile. Every backward library
// exports them, so its wrapper sizes the scratch from the library it launches
// and the two cannot disagree.
extern "C" long long nerf_mlp_param_count(int has_dir, int xyz, int dir, int hid, int last) {
  const nerf_mlp::Dims dm{0, xyz, dir, hid, last, has_dir, 0.f};
  const nerf_mlp::Layout L = nerf_mlp::make_layout(dm);
  return (long long)L.total_w + L.total_b;
}

extern "C" int nerf_mlp_bwd_rows_per_tile() { return nerf_mlp::TM; }
extern "C" int nerf_mlp_bwd_act_slots() { return nerf_mlp::NACT * nerf_mlp::TM * nerf_mlp::HMAX; }
