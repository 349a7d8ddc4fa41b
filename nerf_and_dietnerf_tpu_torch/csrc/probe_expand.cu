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
// What bounds them on an H100: A and B bytes. A at the tool's 4,096 rows
// moves 32 KB (16 in, 16 out): 0.01 us at 3.35 TB/s, far below one launch's
// latency (microseconds), so A's device time is that latency and its time a
// call is the host's: the wrapper and the launch. B at the tool's shape (rd
// (64, 8) -> (4096, 8)) reads 2,048 bytes and writes 131,072: 133,120 bytes,
// 0.04 us (0.00004 ms) at 3.35 TB/s, so B's device time too is a launch's
// latency and its time a call the host's. C operations: per row 6 T + T E
// multiply-adds and T sinf against 12 + 12 / S bytes in and 4 E out; at the
// tool's 65,536 rows (T = 114, E = 33) 0.58 GFLOP of FMAs and 7.5 M sinf at
// 40 FLOP each over 67 TFLOP/s, 0.0132 ms (bytes would give 0.0029).
//
// What the design does about that: A is one thread per four outputs, with
// 16-byte loads and stores where both pointers are 16-byte aligned, and one
// thread per output for the tail (and for pointers that are not). Its
// wrapper (ops/probe_kernels_cuda.expand_a) is the lean launch path: one
// inline check, `new_empty` for the output, the stream read as its raw
// handle.
//
// B. The former design gave each thread one output element and found its
// source with three divisions by runtime values. Here the output's flat
// index is s (R_t X) + j for rd's flat index j, so no division is needed:
// each thread of the x grid loads one element of rd, a float4 where R_t X is
// a multiple of 4 and both pointers are 16-byte aligned, else a float (rd
// may be a view at any offset), doubles it (exact in f32: bitwise the plain
// version) and stores it into samples blockIdx.y, blockIdx.y + gridDim.y,
// and so on. Its wrapper (expand_b) takes A's lean launch path.
//
// C. The former design had one thread per (row, column) write sin(theta)
// to a shared tile, then one thread per (row, output column) sum its T
// products; every FMA of both phases read two operands from shared memory
// (sin_s and gx_s, u_s and sc_s), about 16 M warp-wide loads, about one a
// clock an SM: reckoned 0.08 ms of the 0.123 it took a call on an H100 SXM.
// Here a thread owns a whole row: it
// reads the row's six inputs from global memory once (consecutive threads
// take consecutive rows of px, py, pz: coalesced), then walks the T angle
// columns in order, each time computing theta (six FMAs in k order) and the
// full-range sinf in registers and adding sin * gx[c, :] into E <= 33
// register accumulators (one f32 chain each in ascending c): the sines
// never touch shared memory, and every shared load of the loop (a column of
// sc, a row of gx, as float4) is one address for the whole warp and feeds 4
// FMAs. The block keeps sc (transposed) and gx in shared memory, then stages
// its outputs over them and writes them out coalesced; at 34 KB (no launch
// attribute to set) and 256 threads two blocks share an SM, so one block's
// sines overlap another's products. Each output takes the former kernel's
// f32 operations in the former order. Its wrapper takes P4's lean path: its
// checks inline, `new_empty` for the output.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_E = 33;  // output columns probe C takes: the TPU probe's encode width

// (S, R_t) row-major already holds row s * R_t + r at flat index s * R_t + r.
// Threads [0, n4) take four outputs each, the rest one each from 4 n4 on.
__global__ void expand_a_kernel(const float* __restrict__ zt, float* __restrict__ out, int n4,
                                int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(zt)[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (3 * n4 + i < n) {
    out[3 * n4 + i] = zt[3 * n4 + i] + 1.0f;
  }
}

__device__ __forceinline__ float twice(float v) { return v * 2.0f; }
__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

// rd's m elements of T (float4 or float), doubled into each sample's copy.
template <typename T>
__global__ void expand_b_kernel(const T* __restrict__ rd, T* __restrict__ out, int m, int n_s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const T v = twice(rd[i]);
  for (int s = blockIdx.y; s < n_s; s += gridDim.y) out[(size_t)s * m + i] = v;
}

constexpr int MAX_GRID_Y = 65535;

// C: a thread a row, C_ROWS consecutive rows a block; rows are global
// (tile tile_rows + s R_t + r is px's flat index).
constexpr int C_ROWS = 256;

constexpr int GS = (MAX_E + 3) & ~3;  // floats of a gx row in shared memory: float4s

// sc and gx for the loop, then the block's staged outputs over them.
constexpr size_t expand_c_smem(int T, int E) {
  const size_t tables = (size_t)8 * T + (size_t)GS * T, staged = (size_t)C_ROWS * E;
  return sizeof(float) * (tables > staged ? tables : staged);
}

// MAX_E accumulators a row; the columns past E are computed and dropped.
__global__ void __launch_bounds__(C_ROWS, 2)
    expand_c_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ vc,
                    const float* __restrict__ sc, const float* __restrict__ gx,
                    float* __restrict__ out, int r_t, int tile_rows, int n_rows, int T, int E) {
  extern __shared__ __align__(16) float smem[];
  float* sct = smem;         // (T, 8): sc[k, c] at sct[8 c + k], k < 6
  float* gxs = sct + 8 * T;  // (T, GS): gx, zero past E
  float* outs = smem;        // (C_ROWS, E): the block's outputs, once sc and gx are done
  const int tid = threadIdx.x, row0 = blockIdx.x * C_ROWS, row = row0 + tid;

  // Unrolled, so that a thread's global loads are in flight together.
#pragma unroll 4
  for (int i = tid; i < 8 * T; i += C_ROWS) {
    const int c = i >> 3, k = i & 7;
    sct[i] = k < 6 ? sc[k * T + c] : 0.f;
  }
#pragma unroll 8
  for (int i = tid; i < GS * T; i += C_ROWS) {
    const int c = i / GS, e = i % GS;
    gxs[i] = e < E ? gx[c * E + e] : 0.f;
  }
  // u = [px | py | pz | vc] of the thread's row (a row past n: 0).
  const bool in = row < n_rows;
  const size_t v = in ? ((size_t)(row / tile_rows) * r_t + row % r_t) * 3 : 0;
  const float u[6] = {in ? px[row] : 0.f, in ? py[row] : 0.f, in ? pz[row] : 0.f,
                      in ? vc[v] : 0.f,   in ? vc[v + 1] : 0.f, in ? vc[v + 2] : 0.f};
  __syncthreads();

  float acc[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) acc[e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < T; ++c) {
    const float4 s0 = *reinterpret_cast<const float4*>(sct + 8 * c);
    const float4 s1 = *reinterpret_cast<const float4*>(sct + 8 * c + 4);
    float th = 0.f;
    th = fmaf(u[0], s0.x, th);
    th = fmaf(u[1], s0.y, th);
    th = fmaf(u[2], s0.z, th);
    th = fmaf(u[3], s0.w, th);
    th = fmaf(u[4], s1.x, th);
    th = fmaf(u[5], s1.y, th);
    const float sn = sinf(th);
    const float4* g4 = reinterpret_cast<const float4*>(gxs + GS * c);
#pragma unroll
    for (int q = 0; q < GS / 4; ++q) {
      const float4 w4 = g4[q];
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < MAX_E) acc[4 * q + e] = fmaf(sn, w[e], acc[4 * q + e]);
    }
  }
  __syncthreads();
  float* o = outs + tid * E;
#pragma unroll
  for (int e = 0; e < MAX_E; ++e)
    if (e < E) o[e] = acc[e];
  __syncthreads();
  const int rows = min(C_ROWS, n_rows - row0);
#pragma unroll 4
  for (int i = tid; i < rows * E; i += C_ROWS) out[(size_t)row0 * E + i] = outs[i];
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_expand_a(const float* zt, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(zt) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int n4 = vec ? n / 4 : 0;
  const int threads = n - 3 * n4;  // n4 vector threads and n - 4 n4 scalar ones
  expand_a_kernel<<<(threads + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      zt, out, n4, n);
  return (int)cudaGetLastError();
}

extern "C" int nerf_probe_expand_b(const float* rd, float* out, int r_t, int n_s, int width,
                                   void* stream) {
  if (r_t <= 0 || n_s <= 0 || width <= 0) return 0;
  const long long m = (long long)r_t * width;
  if (m > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(rd) | reinterpret_cast<uintptr_t>(out);
  const bool vec = m % 4 == 0 && (addr & 15) == 0;
  const int units = (int)(vec ? m / 4 : m);
  const int threads = units < NT ? (units + 31) & ~31 : NT;
  const dim3 grid((units + threads - 1) / threads, n_s < MAX_GRID_Y ? n_s : MAX_GRID_Y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    expand_b_kernel<<<grid, threads, 0, st>>>(reinterpret_cast<const float4*>(rd),
                                              reinterpret_cast<float4*>(out), units, n_s);
  else
    expand_b_kernel<<<grid, threads, 0, st>>>(rd, out, units, n_s);
  return (int)cudaGetLastError();
}

extern "C" int nerf_probe_expand_c(const float* px, const float* py, const float* pz,
                                   const float* vc, const float* sc, const float* gx, float* out,
                                   int n_tiles, int r_t, int n_s, int T, int E, void* stream) {
  if (n_tiles <= 0 || r_t <= 0 || n_s <= 0) return 0;
  const size_t smem = expand_c_smem(T, E);
  if (T < 0 || E <= 0 || E > MAX_E || smem > 232448) return (int)cudaErrorInvalidValue;
  const int n_rows = n_tiles * n_s * r_t;
  if (smem > 48 * 1024)  // above what a block gets without asking (not at the tools' shapes)
    cudaFuncSetAttribute(expand_c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  expand_c_kernel<<<(n_rows + C_ROWS - 1) / C_ROWS, C_ROWS, smem,
                    static_cast<cudaStream_t>(stream)>>>(px, py, pz, vc, sc, gx, out, r_t,
                                                         n_s * r_t, n_rows, T, E);
  return (int)cudaGetLastError();
}
