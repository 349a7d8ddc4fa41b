// Device code of the ray-march kernels B6 (raymarch_fwd.cu, raymarch_bwd.cu)
// on the tensor-core tiles: each row's features built straight into the
// operand tiles that mlp_mma_tile.cuh (bf16), mlp_tf32_tile.cuh (the f32
// forward) and mlp_tf32_mma_tile.cuh (the f32 backward) read, so the (N, xyz)
// and (N, dir) encodings never reach device memory.
//
// A feature is what build_inputs (raymarch_common.cuh) computes: the point
// o + z d from __fadd_rn / __fmul_rn, theta = f_k v (+ pi/2 for a cos
// column), the full-range sinf, in the reference's coordinate-major column
// order; the bf16 tiles round it once. Rows are ray-major (row = ray * S +
// sample); B6 composites nothing, so a 128-row tile may span rays and S need
// not divide it. The bf16 tile build and its features take a stage (EncStage)
// whose default, ENC_FULL, is what every kernel runs; the encode-cost probe
// (probe_enccost.cu) cuts them off after an earlier stage.
//
// f32 input columns (RayTf32Inputs): 64 more floats at the end of every
// activation-tile row (row stride 260 -> 324 floats: 1,296 bytes, 16 more
// than a multiple of 128, so the eight rows an `ldmatrix` phase reads fall in
// eight bank groups), x in columns [0, kx), d in [kx, kx + kd) of them (kx =
// pad8(xyz), kd = pad8(dir), kx + kd <= 64). An input fragment is addressed
// from the warp's activation rows like any activation fragment, so it costs
// the consumers no register. With two ring stages instead of B1's three the
// f32 forward's shared memory is ring 2 x 2 x 256 x 16 x 4 = 65,536 + tile
// 128 x 324 x 4 = 165,888 + 4 mbarriers 32 = 231,456 of 232,448 bytes. Each
// consumer warp builds and reads only its own 16 rows (as it writes and
// reads their activations), so the build needs no barrier beyond
// `__syncwarp`; no layer writes past column 256.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "mlp_mma_tile.cuh"
#include "mlp_tf32_mma_tile.cuh"
#include "mlp_tf32_tile.cuh"
#include "raymarch_common.cuh"

namespace nerf_rm {

// How far the bf16 tile build goes. The kernels run it whole (ENC_FULL); the
// encode-cost probe cuts it off after a stage, each stage doing the work of
// the one before it, and reads what the tiles then hold (f32, unrounded,
// before ENC_FULL):
//   ENC_REPEAT  X: its ray's data and z, column c: rd[ray, c % (6 + D)] +
//               z[ray, c % S]; D: the view component its column encodes
//   ENC_PTS     X: the row's point coordinate in every column of that
//               coordinate; D as ENC_REPEAT
//   ENC_THETA   the angles before the sin (identity columns: the coordinate)
//   ENC_SIN     the features
//   ENC_FULL    the features rounded to bf16 (B6's tiles)
enum EncStage { ENC_REPEAT = 1, ENC_PTS, ENC_THETA, ENC_SIN, ENC_FULL };

// Feature c (< xyz) of row `row`'s xyz encoding, in f32.
template <int STAGE = ENC_FULL>
__device__ __forceinline__ float xyz_feature(const Rays& ry, int row, int c) {
  const int per = 1 + 2 * ry.L, j = c % per;
  const float* ray = ry.rd + (size_t)(row / ry.S) * (6 + ry.D);
  if constexpr (STAGE == ENC_REPEAT)
    return ray[c % (6 + ry.D)] + ry.z[(size_t)(row / ry.S) * ry.S + c % ry.S];
  const float p = point(ray, ry.z[row], c / per);
  if constexpr (STAGE == ENC_PTS) return p;
  if constexpr (STAGE == ENC_THETA) return j == 0 ? p : enc_theta(p, (j - 1) >> 1, (j - 1) & 1);
  return j == 0 ? p : sinf(enc_theta(p, (j - 1) >> 1, (j - 1) & 1));
}

// Feature c (< dir) of row `row`'s view-dir encoding, in f32.
template <int STAGE = ENC_FULL>
__device__ __forceinline__ float dir_feature(const Rays& ry, int row, int c) {
  const int perd = 2 * ry.Ld, j = c % perd;
  const float v = ry.rd[(size_t)(row / ry.S) * (6 + ry.D) + 6 + c / perd];
  if constexpr (STAGE == ENC_REPEAT || STAGE == ENC_PTS) return v;
  if constexpr (STAGE == ENC_THETA) return enc_theta(v, j >> 1, j & 1);
  return sinf(enc_theta(v, j >> 1, j & 1));
}

// The bf16 tiles X (BM x LDX) and D (BM x LDD) of rows [row0, row0 + BM),
// one thread per (row, column): columns [width, pad16(width)) and rows at or
// past n are zero, as load_tile leaves them. A STAGE before ENC_FULL writes
// its f32 values into f32 tiles of the same strides.
template <int STAGE = ENC_FULL, typename T = nerf_mma::bf16>
__device__ inline void build_mma_inputs(const Rays& ry, int xyz, int dir, int row0, int n, T* X,
                                        T* D) {
  static_assert((STAGE == ENC_FULL) == std::is_same<T, nerf_mma::bf16>::value &&
                    (STAGE == ENC_FULL || std::is_same<T, float>::value),
                "bf16 tiles hold the whole features, f32 tiles an earlier stage's");
  using nerf_mma::BM;
  const int xp = nerf_mma::pad16(xyz);
  for (int i = threadIdx.x; i < BM * xp; i += nerf_mma::NT) {
    const int r = i / xp, c = i - r * xp, row = row0 + r;
    const float v = row < n && c < xyz ? xyz_feature<STAGE>(ry, row, c) : 0.f;
    if constexpr (STAGE == ENC_FULL)
      X[r * nerf_mma::LDX + c] = __float2bfloat16_rn(v);
    else
      X[r * nerf_mma::LDX + c] = v;
  }
  if (ry.D == 0) return;
  const int dp = nerf_mma::pad16(dir);
  for (int i = threadIdx.x; i < BM * dp; i += nerf_mma::NT) {
    const int r = i / dp, c = i - r * dp, row = row0 + r;
    const float v = row < n && c < dir ? dir_feature<STAGE>(ry, row, c) : 0.f;
    if constexpr (STAGE == ENC_FULL)
      D[r * nerf_mma::LDD + c] = __float2bfloat16_rn(v);
    else
      D[r * nerf_mma::LDD + c] = v;
  }
}

// The f32 tiles X (BM x LDX) and D (BM x LDD) of mlp_tf32_mma_tile.cuh (the
// f32 backwards: B6's, and B7's through raymarch_comp_tile.cuh) for
// rows [row0, row0 + BM), one thread per (row, column), stored swizzled (sw):
// columns [width, pad16(width)) and rows at or past n are zero (the
// weight-gradient products read up to pad16 columns).
__device__ inline void build_t32_inputs(const Rays& ry, int xyz, int dir, int row0, int n,
                                        float* X, float* D) {
  namespace tm = nerf_tmma;
  const int xp = nerf_mma::pad16(xyz);
  for (int i = threadIdx.x; i < tm::BM * xp; i += tm::NT) {
    const int r = i / xp, c = i - r * xp, row = row0 + r;
    X[r * tm::LDX + tm::sw(r, c)] = row < n && c < xyz ? xyz_feature(ry, row, c) : 0.f;
  }
  if (ry.D == 0) return;
  const int dp = nerf_mma::pad16(dir);
  for (int i = threadIdx.x; i < tm::BM * dp; i += tm::NT) {
    const int r = i / dp, c = i - r * dp, row = row0 + r;
    D[r * tm::LDD + tm::sw(r, c)] = row < n && c < dir ? dir_feature(ry, row, c) : 0.f;
  }
}

__device__ __forceinline__ void st_shared_f32(uint32_t p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(p), "f"(v) : "memory");
}
__device__ __forceinline__ float ld_shared_f32(uint32_t p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(p) : "memory");
  return v;
}

// The f32 forward's inputs (the `In` policy of mlp_tf32_tile.cuh): features
// built by each consumer warp into the input columns of its 16 activation-
// tile rows at the start of every tile, read back with `ldmatrix` as the
// activations are; two ring stages. The kernel takes it as a
// `__grid_constant__` parameter, read where it is used, so the consumers keep
// none of it in registers through the products.
struct RayTf32Inputs {
  static constexpr int NSTAGE = 2;
  static constexpr int IN_COLS = 64;  // x | pad | d | pad
  static constexpr int LDA = nerf_tf32::ACT_COLS + IN_COLS;  // tile row stride (floats)
  Rays ry;
  int xyz, dir;

  __device__ __forceinline__ int kx() const { return nerf_tf32::pad8(xyz); }

  // The warp's 16 rows: x | zero pad | d | zero pad; rows past n zero.
  __device__ void begin_tile(const nerf_tf32::Rows& rw) const {
    __syncwarp();
    const unsigned row0 = rw.grow - rw.g;
    for (int i = rw.lane; i < 16 * IN_COLS; i += 32) {
      const int r = i / IN_COLS, c = i % IN_COLS;
      const unsigned row = row0 + r;
      float v = 0.f;
      if (row < rw.n) {
        if (c < xyz) {
          v = xyz_feature(ry, (int)row, c);
        } else if (c >= kx() && c - kx() < dir) {
          v = dir_feature(ry, (int)row, c - kx());
        }
      }
      st_shared_f32(rw.tile + 4 * (r * LDA + nerf_tf32::ACT_COLS + c), v);
    }
    __syncwarp();
  }

  // The A fragment of x (or d) columns k .. k + 8.
  __device__ __forceinline__ void load(uint32_t (&a)[4], bool dir_cols, const nerf_tf32::Rows& rw,
                                       int k) const {
    nerf_tf32::load_tile_a<LDA>(a, rw, nerf_tf32::ACT_COLS + (dir_cols ? kx() : 0) + k);
  }

  // d of the warp's row g + 8 h, column k (< dir).
  __device__ __forceinline__ float d_at(const nerf_tf32::Rows& rw, int h, int k) const {
    return ld_shared_f32(rw.tile + 4 * ((rw.g + 8 * h) * LDA + nerf_tf32::ACT_COLS + kx() + k));
  }
};

static_assert(RayTf32Inputs::LDA == nerf_tf32::Smem<RayTf32Inputs>::LDA, "the tile's row stride");

// Whether the f32 forward's input columns hold these widths.
__host__ __device__ constexpr bool tf32_inputs_fit(int xyz, int dir) {
  return nerf_tf32::pad8(xyz) + nerf_tf32::pad8(dir) <= RayTf32Inputs::IN_COLS;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory; returns the
// launch's error (a refused launch never runs, and no later synchronisation
// reports it).
template <typename K, typename... Args>
inline cudaError_t launch_kernel(K kernel, int blocks, int threads, size_t smem,
                                 cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace nerf_rm
