// P3: B1's forward with several independent 64-row chains per block, walked
// in lockstep, to see whether more rows per streamed weight chunk pay.
//
// Replaces tools/exp_interleave.py `fwd_pallas` (body `make_fwd`): B1's
// arithmetic (view-dir variant) with the tile split into independent row
// chains whose products sit side by side in program order; the output is
// B1's for every split. On the TPU the question was whether the matrix
// unit's pipeline fills. Here B1 loads every 32 x 256 weight chunk from L2
// into shared memory once per 64 rows, behind two block-wide barriers; the
// question becomes whether using each chunk for C x 64 rows (C times fewer
// chunk loads and barriers per row, C x 64 accumulators per thread) beats one
// chain per block.
//
// What bounds it on an H100: operations, as B1.
//
// What the design does about that: a block owns C sub-tiles of TM rows. Each
// chain keeps one f32 activation buffer (a layer's output overwrites its
// input once the product is in registers), its X and D tiles, and an 8 x 8
// accumulator tile per thread. Sums run in B1's order (the same k order, one
// fmaf chain per output), so the result is bitwise B1's. Shared memory holds
// one or two chains of f32 activations (88 KB a chain + the 32 KB chunk);
// four need 384 KB, and 256 accumulators a thread: the wrapper refuses them.
#include "mlp_common.cuh"

using namespace nerf_mlp;

constexpr size_t CHAIN_FLOATS = TM * HMAX + TM * XMAX + TM * DMAX;

constexpr size_t chains_smem_bytes(int c) {
  return sizeof(float) * (KC * HMAX + c * CHAIN_FLOATS);
}
static_assert(chains_smem_bytes(2) <= 232448, "two chains must fit a block's shared memory");

// acc[c][i][j] += sum_k A_c[(8*ty + i) * lda + k] * W[k, acc_col(tx, j)] with
// A_c = A + c * a_stride: gemm_acc (mlp_common.cuh) for C tiles that share
// every streamed chunk of W.
template <typename T, int C>
__device__ void gemm_acc_chains(float (&acc)[C][8][8], const float* A, size_t a_stride, int lda,
                                int K, const T* __restrict__ W, int N, float* Ws) {
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
#pragma unroll 2
    for (int kk = 0; kk < kc; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(Ws + kk * HMAX + tx * 4);
      const float4 w1 = *reinterpret_cast<const float4*>(Ws + kk * HMAX + 128 + tx * 4);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = a_rows[c * a_stride + i * lda + k0 + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][i][j] = fmaf(a[i], w[j], acc[c][i][j]);
      }
    }
  }
  __syncthreads();
}

template <int C>
__device__ __forceinline__ void zero_chains(float (&acc)[C][8][8]) {
#pragma unroll
  for (int c = 0; c < C; ++c) zero_acc(acc[c]);
}

// Every chain's layer output into its own activation buffer.
template <typename T, int C>
__device__ __forceinline__ void store_chains(const float (&acc)[C][8][8],
                                             const float* __restrict__ bias, int n, float alpha,
                                             float* H) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    store_act<T>(acc[c], bias, n, alpha, H + c * CHAIN_FLOATS);
}

template <typename T, int C>
__global__ void __launch_bounds__(NT, 1)
    mlp_fwd_chains_kernel(Dims dm, Layout L, const T* __restrict__ x, const T* __restrict__ d,
                          const T* __restrict__ W, const float* __restrict__ B,
                          float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);
  float* H = Ws + KC * HMAX;            // chain c's buffers start at H + c * CHAIN_FLOATS
  float* X = H + TM * HMAX;
  float* D = X + TM * XMAX;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * (C * TM);
  for (int c = 0; c < C; ++c) {
    load_rows<T>(X + c * CHAIN_FLOATS, XMAX, x, dm.xyz, row0 + c * TM, dm.n);
    load_rows<T>(D + c * CHAIN_FLOATS, DMAX, d, dm.dir, row0 + c * TM, dm.n);
  }
  __syncthreads();

  float acc[C][8][8];
  for (int l = 0; l < N_TRUNK; ++l) {
    zero_chains<C>(acc);
    if (l == 0) {
      gemm_acc_chains<T, C>(acc, X, CHAIN_FLOATS, XMAX, dm.xyz, W + L.w[0], dm.hid, Ws);
    } else if (l == SKIP) {
      gemm_acc_chains<T, C>(acc, X, CHAIN_FLOATS, XMAX, dm.xyz, W + L.w[SKIP], dm.hid, Ws);
      gemm_acc_chains<T, C>(acc, H, CHAIN_FLOATS, HMAX, dm.hid, W + L.w[SKIP + 1], dm.hid, Ws);
    } else {
      gemm_acc_chains<T, C>(acc, H, CHAIN_FLOATS, HMAX, dm.hid, W + L.w[trunk_w(l)], dm.hid, Ws);
    }
    // In place: the products above ended with a barrier.
    store_chains<T, C>(acc, B + L.b[l], dm.hid, dm.alpha, H);
  }
  __syncthreads();

  // Heads (view-dir variant), one (row, channel) per thread and chain. sigma
  // reads h8, which the rgb hidden layer overwrites: take it first.
  const int r = tid >> 2, j = tid & 3;
  zero_chains<C>(acc);
  gemm_acc_chains<T, C>(acc, H, CHAIN_FLOATS, HMAX, dm.hid, W + L.w[9], dm.last, Ws);
  gemm_acc_chains<T, C>(acc, D, CHAIN_FLOATS, DMAX, dm.dir, W + L.w[10], dm.last, Ws);
  float sigma[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sigma[c] = 0.f;
    if (j == 3) {
      const float* h8 = H + c * CHAIN_FLOATS;
      const float* dt = D + c * CHAIN_FLOATS;
      const T* wh = W + L.w[12];
      const T* wd = W + L.w[13];
      float sh = 0.f, sd = 0.f;
      for (int k = 0; k < dm.hid; ++k) sh = fmaf(h8[r * HMAX + k], to_f<T>(wh[k]), sh);
      for (int k = 0; k < dm.dir; ++k) sd = fmaf(dt[r * DMAX + k], to_f<T>(wd[k]), sd);
      sigma[c] = (sh + sd) + B[L.b[10]];
    }
  }
  __syncthreads();
  store_chains<T, C>(acc, B + L.b[8], dm.last, dm.alpha, H);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int row = row0 + c * TM + r;
    if (row >= dm.n) continue;
    float v = sigma[c];
    if (j < 3) {
      const float* rgb_h = H + c * CHAIN_FLOATS;
      const T* w = W + L.w[11];
      float s = 0.f;
      for (int k = 0; k < dm.last; ++k) s = fmaf(rgb_h[r * HMAX + k], to_f<T>(w[k * 3 + j]), s);
      v = s + B[L.b[9] + j];
    }
    out[(size_t)row * 4 + j] = v;
  }
}

template <typename T, int C>
static int launch(const Dims& dm, const void* x, const void* d, const void* w, const float* b,
                  float* out, cudaStream_t stream) {
  const Layout L = make_layout(dm);
  const int blocks = (dm.n + C * TM - 1) / (C * TM);
  if (blocks == 0) return 0;
  const size_t smem = chains_smem_bytes(C);
  cudaFuncSetAttribute(mlp_fwd_chains_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mlp_fwd_chains_kernel<T, C><<<blocks, NT, smem, stream>>>(
      dm, L, static_cast<const T*>(x), static_cast<const T*>(d), static_cast<const T*>(w), b, out);
  return (int)cudaGetLastError();
}

// Shared memory a block of `n_chains` chains needs, in bytes.
extern "C" long long nerf_probe_chains_smem(int n_chains) {
  return (long long)chains_smem_bytes(n_chains);
}

// n_chains: 1 or 2. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_mlp_chains(int is_bf16, int n_chains, const void* x, const void* d,
                                     const void* w, const float* b, float* out, int n, int xyz,
                                     int dir, int hid, int last, float alpha, void* stream) {
  const Dims dm{n, xyz, dir, hid, last, 1, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chains == 1)
    return is_bf16 ? launch<__nv_bfloat16, 1>(dm, x, d, w, b, out, s)
                   : launch<float, 1>(dm, x, d, w, b, out, s);
  if (n_chains == 2)
    return is_bf16 ? launch<__nv_bfloat16, 2>(dm, x, d, w, b, out, s)
                   : launch<float, 2>(dm, x, d, w, b, out, s);
  return (int)cudaErrorInvalidValue;
}
