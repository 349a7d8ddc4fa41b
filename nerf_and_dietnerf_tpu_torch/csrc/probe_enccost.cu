// P7: what each stage of bf16 B6's in-kernel encode costs, by cutting it short.
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
// As in the TPU probe, each stage does the work of the one before it: after
// `dma`, each fills both tiles (EncStage in raymarch_tile.cuh).
//
// What bounds it on an H100: operations. A row of `enc` is 2,307 FLOP: the
// point under each of its 33 xyz columns (a product and a sum), 54 angles (a
// product, and a sum for the cos half) and 54 full-range sinf at about 40
// FLOP each, against 67 TFLOP/s of f32 (no tensor cores): 0.60 GFLOP, 9.0 us
// at the tool's 262,144 rows. Its bytes (36 / S + 4 in and 16 out a row,
// 5.4 MB) take 1.6 us. `dma` to `pts` are bound by their bytes.
//
// What the design does about that: it is bf16 B6's own input build at B6's
// occupancy, so a stage's time is that stage of B6's forward and not of a
// re-implementation. The stages run build_mma_inputs (raymarch_tile.cuh: one
// thread per (row, column) of the padded tiles, the features of
// xyz_feature / dir_feature) cut off by its STAGE parameter, in B6's grid and
// block (128 rows, nerf_mma::NT threads) with B6's forward shared memory
// reserved (fwd_smem_bytes, make_tiles), so one block runs an SM, as in B6.
// `enc` writes B6's bf16 X / D tiles; the stages before it write their f32
// values, unrounded, into f32 tiles of the same strides laid over the
// activation tile P, which B6 fills only after the build. Only the summary's
// four floats a row and `dma` (B6 reads a ray's data where it uses it) are
// the probe's own. Nothing here closes the gap to the bound: it is B6's (one
// block an SM, 16 waves of blocks on 2,048 tiles, each thread's loads and
// sinf one entry at a time), and closing it is a redesign of B6 itself
// (`wgmma`, the build overlapped with the products), which this probe will
// then follow.
#include "raymarch_tile.cuh"

using namespace nerf_rm;

constexpr int ENC_DMA = 0;  // before the stages of build_mma_inputs (EncStage)
constexpr int BM = nerf_mma::BM;
constexpr int LDX = nerf_mma::LDX, LDD = nerf_mma::LDD;
static_assert(4 * BM * (LDX + LDD) <= 2 * BM * nerf_mma::LDH,
              "the f32 tiles of the early stages fit in the activation tile P");

// The `dma` stage: the block's own ray data (flat in X) and depths (flat in
// Dt), each element read once, no per-row copy.
__device__ void load_tile_data(const Rays& ry, int row0, int row_end, float* X, float* Dt) {
  const int width = 6 + ry.D;
  const int ray0 = row0 / ry.S;
  const int n_ray = ((min(row0 + BM, row_end) - 1) / ry.S - ray0 + 1) * width;
  for (int idx = threadIdx.x; idx < n_ray; idx += nerf_mma::NT)
    X[idx] = ry.rd[(size_t)ray0 * width + idx];
  for (int idx = threadIdx.x; idx < BM; idx += nerf_mma::NT)
    Dt[idx] = row0 + idx < row_end ? ry.z[row0 + idx] : 0.f;
}

template <int STAGE>
__global__ void __launch_bounds__(nerf_mma::NT, 1)
    enc_cost_kernel(Rays ry, int xyz, int dir, int r_t, float* __restrict__ out) {
  extern __shared__ uint4 smem16[];
  const nerf_mma::Tiles t = nerf_mma::make_tiles(smem16, false);
  float* X = reinterpret_cast<float*>(t.P);  // f32 tiles of the stages before `enc`
  float* D = X + BM * LDX;
  const int n = ry.R * ry.S;
  const int row0 = blockIdx.x * BM;
  if constexpr (STAGE == ENC_DMA)
    load_tile_data(ry, row0, n, X, D);
  else if constexpr (STAGE == ENC_FULL)
    build_mma_inputs(ry, xyz, dir, row0, n, t.X, t.D);
  else
    build_mma_inputs<STAGE>(ry, xyz, dir, row0, n, X, D);
  __syncthreads();

  const int per = 1 + 2 * ry.L;
  for (int i = threadIdx.x; i < BM * 4; i += nerf_mma::NT) {
    const int r = i >> 2, j = i & 3, row = row0 + r;
    if (row >= n) break;
    const int ray = row / ry.S, s = row % ry.S;
    const int tile = ray / r_t;
    float v;
    if constexpr (STAGE == ENC_DMA) {
      // The block that starts at the tile's first ray has both in its own copy.
      const size_t first = (size_t)tile * r_t;
      const bool mine = first * ry.S == (size_t)row0;
      v = (0.f + (mine ? X[0] : ry.rd[first * (6 + ry.D)])) + (mine ? D[0] : ry.z[first * ry.S]);
    } else if constexpr (STAGE == ENC_REPEAT) {
      v = X[r * LDX + j];
    } else if constexpr (STAGE == ENC_PTS) {
      v = j < 3 ? X[r * LDX + j * per] : ry.z[row];
    } else if constexpr (STAGE == ENC_THETA || STAGE == ENC_SIN) {
      // TPU angle column j is coordinate j / L, octave j % L, sin.
      v = X[r * LDX + (j / ry.L) * per + 1 + 2 * (j % ry.L)];
    } else {
      v = (0.f + __bfloat162float(t.X[r * LDX])) + __bfloat162float(t.D[r * LDD]);
    }
    out[((size_t)(tile * ry.S + s) * r_t + (ray % r_t)) * 4 + j] = v;
  }
}

template <int STAGE>
static int launch(const Rays& ry, int xyz, int dir, int r_t, float* out, cudaStream_t stream) {
  const int tiles = (ry.R * ry.S + BM - 1) / BM;
  if (tiles == 0) return 0;
  return (int)launch_kernel(enc_cost_kernel<STAGE>, tiles, nerf_mma::NT,
                            nerf_mma::fwd_smem_bytes(), stream, ry, xyz, dir, r_t, out);
}

// stage: 0 dma, 1 repeat, 2 pts, 3 theta, 4 sin, 5 enc. R must be a multiple
// of r_t. Returns the launch's error (0 on success).
extern "C" int nerf_probe_enccost(int stage, const float* rd, const float* z, float* out, int R,
                                  int S, int L, int Ld, int D, int r_t, void* stream) {
  if (D <= 0 || L < 2 || S < 4 || r_t <= 0 || R % r_t) return (int)cudaErrorInvalidValue;
  const int xyz = 3 + 6 * L, dir = 2 * Ld * D;
  if (xyz > LDX - 8 || dir > LDD - 8 || dir < 4) return (int)cudaErrorInvalidValue;
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
