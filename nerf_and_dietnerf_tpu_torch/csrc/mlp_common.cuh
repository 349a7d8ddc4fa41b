// Shared device code of the radiance-MLP kernels (mlp_fwd.cu, mlp_bwd.cu) and
// of every kernel that runs the MLP inside it.
//
// One thread block owns a tile of TM = 64 rows (ray samples). The tile's
// activations live in shared memory as float (values already rounded to the
// compute type T where the reference rounds them); the weights, too large to
// sit in shared memory as a whole (about 1 MB in bf16, 2 MB in f32), stream
// through a KC x 256 shared-memory chunk, layer by layer. Products run as
// plain f32 FMAs: a bf16 x bf16 product is exact in f32, so the bf16 path
// has the tensor-core semantics (exact products, f32 sums), and the f32 path
// is true f32 with no TF32 rounding. Every other kernel, the probes P2 and P3
// included, runs the tensor-core tiles instead (mlp_mma_tile.cuh,
// mlp_tf32_tile.cuh, mlp_tf32_mma_tile.cuh), which include this header for
// the flat parameter layout below; this FMA tile's forward_tile serves only
// f32 B6's forward at widths over 64 input columns (raymarch_fwd.cu, no
// config of the repository).
//
// Flat parameter layout (the Python wrapper builds the same one): the weight
// matrices, each row-major (K, N), in the order
//   trunk w0 (xyz,hid), w1..w3 (hid,hid), w4a (xyz,hid), w4b (hid,hid),
//   w5..w7 (hid,hid), then
//   view-dir variant: wrh_h (hid,last), wrh_d (dir,last), wro (last,3),
//                     wsig_h (hid,1), wsig_d (dir,1);
//   xyz-only variant: wrh0 (hid,hid), wrh (hid,last), wro (last,3),
//                     wsig (hid,1);
// and the biases b0..b7 (hid), then view: brh (last), bro (3), bsig (1);
// xyz-only: brh0 (hid), brh (last), bro (3), bsig (1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace nerf_mlp {

constexpr int TM = 64;        // rows per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int HMAX = 256;     // widest layer; row stride of the activation buffers
constexpr int KC = 32;        // rows of a streamed weight chunk
constexpr int XMAX = 64;      // widest xyz encoding
constexpr int DMAX = 32;      // widest view-dir encoding
constexpr int N_TRUNK = 8;
constexpr int SKIP = 4;       // the encoded input re-joins before trunk layer 4
constexpr int NACT = 10;      // activation slots kept per tile for the backward

struct Dims {
  int n;        // rows
  int xyz;      // xyz encoding width
  int dir;      // view-dir encoding width (0 for the xyz-only variant)
  int hid;      // trunk width
  int last;     // rgb hidden width
  int has_dir;  // 1: view-dir variant, 0: xyz-only variant
  float alpha;  // leaky relu slope
};

struct Layout {
  int w[14];    // element offset of each weight matrix in the flat weight buffer
  int wk[14];   // its rows (fan in)
  int wn[14];   // its columns (fan out)
  int b[12];    // element offset of each bias in the flat bias buffer
  int nw, nb;   // number of weight matrices / biases
  int total_w, total_b;
};

inline Layout make_layout(const Dims& d) {
  Layout L{};
  int i = 0, off = 0;
  auto add_w = [&](int k, int n) { L.w[i] = off; L.wk[i] = k; L.wn[i] = n; off += k * n; ++i; };
  add_w(d.xyz, d.hid);
  for (int l = 1; l < SKIP; ++l) add_w(d.hid, d.hid);
  add_w(d.xyz, d.hid);
  add_w(d.hid, d.hid);
  for (int l = SKIP + 1; l < N_TRUNK; ++l) add_w(d.hid, d.hid);
  if (d.has_dir) {
    add_w(d.hid, d.last); add_w(d.dir, d.last); add_w(d.last, 3);
    add_w(d.hid, 1); add_w(d.dir, 1);
  } else {
    add_w(d.hid, d.hid); add_w(d.hid, d.last); add_w(d.last, 3); add_w(d.hid, 1);
  }
  L.nw = i; L.total_w = off;
  int j = 0; off = 0;
  auto add_b = [&](int n) { L.b[j] = off; off += n; ++j; };
  for (int l = 0; l < N_TRUNK; ++l) add_b(d.hid);
  if (d.has_dir) { add_b(d.last); add_b(3); add_b(1); }
  else { add_b(d.hid); add_b(d.last); add_b(3); add_b(1); }
  L.nb = j; L.total_b = off;
  return L;
}

// Index of trunk layer l's weight matrix (the skip layer has two: w4a, w4b).
__host__ __device__ inline int trunk_w(int l) { return l < SKIP ? l : l + 1; }

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// Round a float to the compute type and back (identity for f32).
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// Column of the thread's j-th accumulator: two 4-wide groups, 128 apart, so
// a warp's float4 reads of a weight row are contiguous and conflict-free.
__device__ __forceinline__ int acc_col(int tx, int j) {
  return (j < 4 ? 0 : 128) + tx * 4 + (j & 3);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A[(8*ty + i) * lda + k] * W[k, acc_col(tx, j)]
// A: (TM, K) float tile in shared memory; W: (K, N) row-major in global
// memory, N <= 256, streamed through Ws (KC x 256 floats, zero past N).
// Ends with a barrier, so the caller may overwrite A afterwards.
template <typename T>
__device__ void gemm_acc(float (&acc)[8][8], const float* A, int lda, int K,
                         const T* __restrict__ W, int N, float* Ws) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float* a_rows = A + ty * 8 * lda;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < kc * HMAX; idx += NT) {
      const int kk = idx / HMAX, n = idx % HMAX;
      Ws[idx] = n < N ? to_f<T>(W[(size_t)(k0 + kk) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = a_rows[i * lda + k0 + kk];
      const float4 w0 = *reinterpret_cast<const float4*>(Ws + kk * HMAX + tx * 4);
      const float4 w1 = *reinterpret_cast<const float4*>(Ws + kk * HMAX + 128 + tx * 4);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// out = round_T(leaky(acc + bias)) for the N valid columns.
template <typename T>
__device__ void store_act(const float (&acc)[8][8], const float* __restrict__ bias, int N,
                          float alpha, float* out) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = acc_col(tx, j);
      if (n < N) {
        float v = acc[i][j] + bias[n];
        v = v >= 0.f ? v : alpha * v;
        out[r * HMAX + n] = round_t<T>(v);
      }
    }
  }
}

// The whole network on one row tile. h8 and the heads' activations are left
// in bufB / bufA. With `out` the (n, 4) raw output rows of the tile are
// written.
template <typename T>
__device__ void forward_tile(const Dims& dm, const Layout& L, const T* __restrict__ W,
                             const float* __restrict__ B, const float* X, const float* D,
                             float* bufA, float* bufB, float* Ws, float* out, int row0) {
  const int tid = threadIdx.x;
  float acc[8][8];
  const float* h = X;
  int ldh = XMAX, K = dm.xyz;
  for (int l = 0; l < N_TRUNK; ++l) {
    zero_acc(acc);
    if (l == SKIP) {
      gemm_acc<T>(acc, X, XMAX, dm.xyz, W + L.w[SKIP], dm.hid, Ws);
      gemm_acc<T>(acc, h, ldh, K, W + L.w[SKIP + 1], dm.hid, Ws);
    } else {
      gemm_acc<T>(acc, h, ldh, K, W + L.w[trunk_w(l)], dm.hid, Ws);
    }
    float* o = (l & 1) ? bufB : bufA;
    store_act<T>(acc, B + L.b[l], dm.hid, dm.alpha, o);
    h = o; ldh = HMAX; K = dm.hid;
  }
  __syncthreads();
  const float* h8 = bufB;
  const int r = tid >> 2, j = tid & 3;  // head outputs: one (row, channel) per thread
  if (dm.has_dir) {
    zero_acc(acc);
    gemm_acc<T>(acc, h8, HMAX, dm.hid, W + L.w[9], dm.last, Ws);
    gemm_acc<T>(acc, D, DMAX, dm.dir, W + L.w[10], dm.last, Ws);
    store_act<T>(acc, B + L.b[8], dm.last, dm.alpha, bufA);
    __syncthreads();
    if (out && row0 + r < dm.n) {
      float v;
      if (j < 3) {
        const T* w = W + L.w[11];
        float s = 0.f;
        for (int k = 0; k < dm.last; ++k) s = fmaf(bufA[r * HMAX + k], to_f<T>(w[k * 3 + j]), s);
        v = s + B[L.b[9] + j];
      } else {
        const T* wh = W + L.w[12];
        const T* wd = W + L.w[13];
        float sh = 0.f, sd = 0.f;
        for (int k = 0; k < dm.hid; ++k) sh = fmaf(h8[r * HMAX + k], to_f<T>(wh[k]), sh);
        for (int k = 0; k < dm.dir; ++k) sd = fmaf(D[r * DMAX + k], to_f<T>(wd[k]), sd);
        v = (sh + sd) + B[L.b[10]];
      }
      out[(size_t)(row0 + r) * 4 + j] = v;
    }
  } else {
    // sigma reads h8, which the rgb branch overwrites below: take it first.
    float sigma = 0.f;
    if (out && j == 3) {
      const T* ws = W + L.w[12];
      for (int k = 0; k < dm.hid; ++k) sigma = fmaf(h8[r * HMAX + k], to_f<T>(ws[k]), sigma);
      sigma += B[L.b[11]];
    }
    zero_acc(acc);
    gemm_acc<T>(acc, h8, HMAX, dm.hid, W + L.w[9], dm.hid, Ws);
    store_act<T>(acc, B + L.b[8], dm.hid, dm.alpha, bufA);
    zero_acc(acc);
    gemm_acc<T>(acc, bufA, HMAX, dm.hid, W + L.w[10], dm.last, Ws);
    store_act<T>(acc, B + L.b[9], dm.last, dm.alpha, bufB);
    __syncthreads();
    if (out && row0 + r < dm.n) {
      float v = sigma;
      if (j < 3) {
        const T* w = W + L.w[11];
        float s = 0.f;
        for (int k = 0; k < dm.last; ++k) s = fmaf(bufB[r * HMAX + k], to_f<T>(w[k * 3 + j]), s);
        v = s + B[L.b[10] + j];
      }
      out[(size_t)(row0 + r) * 4 + j] = v;
    }
  }
}

constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * TM * HMAX + KC * HMAX + TM * XMAX + TM * DMAX);
}

}  // namespace nerf_mlp
