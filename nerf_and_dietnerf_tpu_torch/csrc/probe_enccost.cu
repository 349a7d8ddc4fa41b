// P7: what each stage of B6's in-kernel encode costs, by cutting it short.
//
// Replaces tools/exp_enccost.py `make_probe(stage)`: B6's grid and tiles with
// the encode cut off after `dma`, `repeat`, `pts`, `theta`, `sin` or `enc`,
// each writing a (rows, 4) f32 summary of what it made, in the TPU probe's
// row order (tiles of r_t rays, sample-major inside a tile: row =
// (tile S + s) r_t + r):
//   dma     rd[tile's first ray, 0] + z[tile's first ray, 0] in every entry
//   repeat  rd[ray, 0:4] + z[ray, 0:4]
//   pts     [o + z d | z]
//   theta   the TPU kernel's first four angle columns (sin columns of x)
//   sin     their sines
//   enc     bf16(x) + bf16(first view-dir feature) in all four entries
//
// What bounds it on an H100: bytes for `dma` to `pts` (16 bytes out a row
// against 4 + 36 / S in); `theta` to `enc` operations: 57 angle products and,
// from `sin` on, 54 full-range sinf per row.
//
// What the design does about that: it is B6's own input stage
// (`build_inputs` in raymarch_common.cuh: a block per 64 ray-major rows, one
// thread per (row, column) of the input tiles in shared memory), cut off by a
// template parameter, so a stage's time is that stage of B6 and not of a
// re-implementation; only the summary's four floats a row are new, and the
// `dma` stage, which B6 has no like of (it reads a ray's data where it uses
// it): `load_tile_data` below.
#include "raymarch_common.cuh"

using namespace nerf_mlp;
using namespace nerf_rm;

constexpr int ENC_DMA = 0;  // before the stages of build_inputs (EncStage)

// The `dma` stage: the block's own ray data (flat in X) and depths (flat in
// Dt), each element read once, no per-row copy.
__device__ void load_tile_data(const Rays& ry, int row0, int row_end, float* X, float* Dt) {
  const int width = 6 + ry.D;
  const int ray0 = row0 / ry.S;
  const int n_ray = ((min(row0 + TM, row_end) - 1) / ry.S - ray0 + 1) * width;
  for (int idx = threadIdx.x; idx < n_ray; idx += NT) X[idx] = ry.rd[(size_t)ray0 * width + idx];
  for (int idx = threadIdx.x; idx < TM; idx += NT)
    Dt[idx] = row0 + idx < row_end ? ry.z[row0 + idx] : 0.f;
}

template <int STAGE>
__global__ void __launch_bounds__(NT, 1)
    enc_cost_kernel(Rays ry, int xyz, int dir, int r_t, float* __restrict__ out) {
  __shared__ float X[TM * XMAX];
  __shared__ float Dt[TM * DMAX];
  const int n = ry.R * ry.S;
  const int row0 = blockIdx.x * TM;
  if constexpr (STAGE == ENC_DMA)
    load_tile_data(ry, row0, n, X, Dt);
  else if constexpr (STAGE == ENC_FULL)
    build_inputs<__nv_bfloat16, ENC_FULL>(ry, xyz, dir, row0, n, X, Dt);
  else
    build_inputs<float, STAGE>(ry, xyz, dir, row0, n, X, Dt);
  __syncthreads();

  const int r = threadIdx.x >> 2, j = threadIdx.x & 3;
  const int row = row0 + r;
  if (row >= n) return;
  const int ray = row / ry.S, s = row % ry.S;
  const int tile = ray / r_t;
  const int per = 1 + 2 * ry.L;
  float v;
  if (STAGE == ENC_DMA) {
    // The block that starts at the tile's first ray has both in its own copy.
    const size_t first = (size_t)tile * r_t;
    const bool mine = first * ry.S == (size_t)row0;
    v = (0.f + (mine ? X[0] : ry.rd[first * (6 + ry.D)])) + (mine ? Dt[0] : ry.z[first * ry.S]);
  } else if (STAGE == ENC_REPEAT) {
    v = X[r * XMAX + j] + Dt[r * DMAX + j];
  } else if (STAGE == ENC_PTS) {
    v = j < 3 ? X[r * XMAX + j * per] : ry.z[row];
  } else if (STAGE == ENC_THETA || STAGE == ENC_SIN) {
    // TPU angle column j is coordinate j / L, octave j % L, sin.
    v = X[r * XMAX + (j / ry.L) * per + 1 + 2 * (j % ry.L)];
  } else {
    v = (0.f + X[r * XMAX]) + Dt[r * DMAX];
  }
  out[((size_t)(tile * ry.S + s) * r_t + (ray % r_t)) * 4 + j] = v;
}

template <int STAGE>
static int launch(const Rays& ry, int xyz, int dir, int r_t, float* out, cudaStream_t stream) {
  const int tiles = (ry.R * ry.S + TM - 1) / TM;
  if (tiles == 0) return 0;
  enc_cost_kernel<STAGE><<<tiles, NT, 0, stream>>>(ry, xyz, dir, r_t, out);
  return (int)cudaGetLastError();
}

// stage: 0 dma, 1 repeat, 2 pts, 3 theta, 4 sin, 5 enc. R must be a multiple
// of r_t. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nerf_probe_enccost(int stage, const float* rd, const float* z, float* out, int R,
                                  int S, int L, int Ld, int D, int r_t, void* stream) {
  if (D <= 0 || L < 2 || S < 4 || r_t <= 0 || R % r_t) return (int)cudaErrorInvalidValue;
  const int xyz = 3 + 6 * L, dir = 2 * Ld * D;
  if (xyz > XMAX || dir > DMAX || dir < 4) return (int)cudaErrorInvalidValue;
  const Rays ry{rd, z, R, S, L, Ld, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case ENC_DMA: return launch<ENC_DMA>(ry, xyz, dir, r_t, out, s);
    case ENC_REPEAT: return launch<ENC_REPEAT>(ry, xyz, dir, r_t, out, s);
    case ENC_PTS: return launch<ENC_PTS>(ry, xyz, dir, r_t, out, s);
    case ENC_THETA: return launch<ENC_THETA>(ry, xyz, dir, r_t, out, s);
    case ENC_SIN: return launch<ENC_SIN>(ry, xyz, dir, r_t, out, s);
    case ENC_FULL: return launch<ENC_FULL>(ry, xyz, dir, r_t, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
