// P4, P5, P6: what it costs to turn per-ray data into per-(ray, sample) rows
// inside a kernel, in the sample-major row order row = s * R_t + r.
//
// Replaces tools/exp_expand.py `probe_a`, `probe_b`, `probe_c`:
//   A  out[s R_t + r] = zt[s, r] + 1            zt (S, R_t) -> (S R_t, 1)
//   B  out[s R_t + r, :] = 2 rd[r, :]           rd (R_t, X) -> (S R_t, X)
//   C  per tile of R_t rays: pts from three (S, R_t) blocks px, py, pz, the
//      tile's view components vc (R_t, 3) repeated for every sample,
//      theta = [pts | vc] @ sc (6, T), sin, enc = sin(theta) @ gx (T, E):
//      (tiles S R_t, E) f32, everything in full f32.
// On the TPU these asked which relayout Mosaic supports and what it costs.
// On this card a row's data is an address computed by its thread, so A and B
// cost their bytes and nothing else; they are kept to say so in numbers.
//
// What bounds them on an H100: A and B bytes (4 in and 4 out per row for A,
// 4 out per element for B; at the tool's 4096 rows both are the size of a
// launch). C operations: per row 6 T + T E multiply-adds and T sinf against
// 12 + 12 / S bytes in and 4 E out.
//
// What the design does about that: A and B are one thread per output
// element. In C a block takes 64 consecutive rows of one tile, keeps sc and
// gx in shared memory, builds the rows' sin(theta) into a shared tile (one
// thread per (row, column), full-range sinf) and then one thread per
// (row, output column) sums its T products in column order.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;
constexpr int ROWS = 64;  // rows of a block in probe C

__global__ void expand_a_kernel(const float* __restrict__ zt, float* __restrict__ out, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  // (S, R_t) row-major already holds row s * R_t + r at flat index s * R_t + r.
  if (i < n) out[i] = zt[i] + 1.0f;
}

__global__ void expand_b_kernel(const float* __restrict__ rd, float* __restrict__ out, int r_t,
                                int width, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int row = i / width, c = i % width;
  out[i] = rd[(row % r_t) * width + c] * 2.0f;
}

__global__ void __launch_bounds__(NT)
    expand_c_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ vc,
                    const float* __restrict__ sc, const float* __restrict__ gx,
                    float* __restrict__ out, int r_t, int n_s, int T, int E) {
  extern __shared__ float smem[];
  float* sc_s = smem;               // (6, T)
  float* gx_s = sc_s + 6 * T;       // (T, E)
  float* u_s = gx_s + T * E;        // (ROWS, 6)
  float* sin_s = u_s + ROWS * 6;    // (ROWS, T)
  const int tid = threadIdx.x;
  const int tile_rows = n_s * r_t;
  const int blocks_per_tile = (tile_rows + ROWS - 1) / ROWS;
  const int tile = blockIdx.x / blocks_per_tile;
  const int row0 = (blockIdx.x % blocks_per_tile) * ROWS;  // within the tile
  const int rows = min(ROWS, tile_rows - row0);

  for (int i = tid; i < 6 * T; i += NT) sc_s[i] = sc[i];
  for (int i = tid; i < T * E; i += NT) gx_s[i] = gx[i];
  for (int i = tid; i < rows * 6; i += NT) {
    const int row = row0 + i / 6, c = i % 6;
    const int s = row / r_t, r = row % r_t;
    const float* p = c == 0 ? px : c == 1 ? py : pz;
    u_s[i] = c < 3 ? p[(size_t)(tile * n_s + s) * r_t + r]
                   : vc[(size_t)(tile * r_t + r) * 3 + (c - 3)];
  }
  __syncthreads();
  for (int i = tid; i < rows * T; i += NT) {
    const int r = i / T, c = i % T;
    float th = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) th = fmaf(u_s[r * 6 + k], sc_s[k * T + c], th);
    sin_s[i] = sinf(th);
  }
  __syncthreads();
  for (int i = tid; i < rows * E; i += NT) {
    const int r = i / E, c = i % E;
    float v = 0.f;
    for (int k = 0; k < T; ++k) v = fmaf(sin_s[r * T + k], gx_s[k * E + c], v);
    out[((size_t)tile * tile_rows + row0 + r) * E + c] = v;
  }
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_expand_a(const float* zt, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  expand_a_kernel<<<(n + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(zt, out, n);
  return (int)cudaGetLastError();
}

extern "C" int nerf_probe_expand_b(const float* rd, float* out, int r_t, int n_s, int width,
                                   void* stream) {
  const int n = r_t * n_s * width;
  if (n <= 0) return 0;
  expand_b_kernel<<<(n + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(rd, out, r_t,
                                                                                  width, n);
  return (int)cudaGetLastError();
}

extern "C" int nerf_probe_expand_c(const float* px, const float* py, const float* pz,
                                   const float* vc, const float* sc, const float* gx, float* out,
                                   int n_tiles, int r_t, int n_s, int T, int E, void* stream) {
  if (n_tiles <= 0 || r_t <= 0 || n_s <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)6 * T + (size_t)T * E + ROWS * 6 + (size_t)ROWS * T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(expand_c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int blocks = n_tiles * ((n_s * r_t + ROWS - 1) / ROWS);
  expand_c_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, vc, sc, gx, out, r_t, n_s, T, E);
  return (int)cudaGetLastError();
}
