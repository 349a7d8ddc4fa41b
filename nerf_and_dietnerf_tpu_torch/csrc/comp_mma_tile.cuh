// The ray-group loops of the MLP + compositing kernels on the tensor-core
// tiles: the backward (backward_groups) of B7 (raymarch_comp_bwd.cu), B5
// (mlp_loss_comp.cu) and B4 (mlp_comp_bwd.cu), and the forward
// (forward_groups) of B4 (mlp_comp_fwd.cu) and B7 (raymarch_comp_fwd.cu). The
// loops take the tile code as a kit: Bf16Kit below (the bf16 `mma.sync` tiles
// of mlp_mma_tile.cuh, 128 rows; every bf16 instance) or nerf_tmma::Kit (the
// 3xTF32 `mma.sync` tiles of mlp_tf32_mma_tile.cuh, 64 rows; every f32
// instance: the backwards of B7, B5 and B4 and the forwards of B7 and B4).
//
// A block owns whole rays, as the compositing needs: a group is the rays
// that fit in one tile of the kit's BM rows, rays_per_group(S, BM) = S >= BM
// ? 1 : BM / S (bf16: two rays at S = 64, one at S = 128, one in a
// part-filled tile at S = 100; f32: one ray at S = 64, one over two tiles at
// S = 128); at S > BM a ray spans ceil(S / BM) tiles. Per group, the backward:
//   1. forward, once per row: for each tile the caller's policy builds X and
//      D, then forward_tile keeps the ten post-activations in that tile's
//      NACT slots and writes the raw values to RAW;
//   2. compositing, one thread per ray (the policy: composite_ray_bwd, for B5
//      first composite_ray, the error and its cotangent);
//   3. the walk: for each tile the GI tile (grgb | gsig | bf16(gsig), as
//      load_cotangent makes it) from GRAW, then backward_walk over the kept
//      slots. B7 and B5: dx goes to the block's BM x xyz f32 slab (the tile
//      as a call of its own, as B6's backward does), and after a barrier one
//      thread per row writes dz = DZC + the policy's share of the points
//      (from the row's dx and its X row, which the f32 kit stores swizzled:
//      the policy reads it through nerf_tmma::sw).
//      B4 (a policy with INPUT_GRADS): dx rows go straight to the policy's
//      output (denc), dd rows to the block's BM x dir f32 slab, which the
//      policy sums per ray in row order, tile after tile (dencd), and dz is
//      DZC alone.
// No row is forwarded twice. Where a group is one tile (bf16 at S <= 128,
// every bf16 training call of these kernels; f32 at S <= 64) X, D and P still
// hold what the walk reads. Otherwise the block keeps every tile's slots
// (tiles_per_group(S, BM) x NACT x BM x 256: 655,360 bytes a tile in either
// kit, 2.6 MB a block at S = 512 in bf16, 5.2 MB in f32, in its scratch) and
// rebuilds X, D and P from them before each tile's walk; recomputing the
// forward instead would cost a third more products.
// The forward runs step 1 without the slots, then composite_ray one thread
// per ray. A kernel's forward and backward run the same forward_tile of the
// same kit on the same tiles (the slots a backward keeps are copies, and
// the ring's next matrix changes no sum), so in either type B4's and B7's
// backwards composite bitwise the raw values their forwards composited.
//
// Shared memory (bytes), bf16 backward: the backward tiles, 209,408, then 9
// floats per row of the group (RAW 4 | GRAW 4 | DZC 1) and one per ray (ERR,
// B5's squared errors): at S <= 128 at most 128 rows and 128 rays, 214,528 in
// all; at S = MAX_S_COMP = 512, 227,844 of the 232,448 a block may use. The
// dx and dd slabs are global (L2), 16,896 and 12,288 bytes a block at the
// flagship widths: 16,384 more bytes of shared memory would not fit beside
// the rows at S = 512. Forward: the forward tiles, 137,728, then RAW, 4
// floats per row: 139,776 at S <= 128, 145,920 at S = 512. The rows in shared
// memory are chosen over an L2 slab such as the dx slab: the tiles alone
// already hold a block alone on its SM, so the rows cost no occupancy, and
// the serial compositing pass, which reads RAW three times and writes GRAW
// and DZC, runs on shared memory's latency. (No L2 variant was built or
// timed.) f32 backward: the tiles of mlp_tf32_mma_tile.cuh, 198,912, then
// the same rows: 201,220 at S = 64, 217,348 at S = 512. f32 forward: its
// forward tiles, 129,280, then RAW: 130,304 at S <= 64, 131,328 at S = 128,
// 137,472 at S = 512 (both asserted in raymarch_comp_tile.cuh, which
// includes both kits).
//
// Weight gradients as B2: each block walks a fixed, strided set of groups
// into its own slab, and a second launch adds the slabs in block order, so
// they are bitwise reproducible (B5's loss share with them). B4's dencd sums
// are each owned by one thread, in row order: reproducible too.
#pragma once

#include <stdint.h>

#include "composite_common.cuh"
#include "mlp_mma_tile.cuh"
#include "t32_phases.cuh"

namespace nerf_cmma {

// Every bf16 product sums each 16-deep step into a fresh accumulator (mma_step):
// with the tensor core's truncating running sum (B2's tile) these kernels sat
// farther from the exact sums than the plain version. A row whose raw sigma
// lies within rounding noise of 0 still crosses the compositing's kink
// (max(sigma, 0); the sigma cotangent is 0 below it) in any other order of
// summation; `raw` lets the checks take the kernel's side of it
// (chip_smoke.py KINK_SHARE, tools/comp_kink.py).
constexpr bool FRESH = true;

using nerf_mlp::Dims;
using nerf_mlp::Layout;
using nerf_mma::BM;
using nerf_mma::bf16;
using nerf_mma::MmaLayout;

// The bf16 tile code (mlp_mma_tile.cuh) as the loops below take it; the f32
// one is nerf_tmma::Kit (mlp_tf32_mma_tile.cuh).
struct Bf16Kit {
  using E = bf16;  // element of the tiles and of the kept slots
  using Pack = MmaLayout;
  using Tiles = nerf_mma::Tiles;
  using Ring = nerf_mma::Ring;
  using Mat = nerf_mma::Mat;
  static constexpr int BM = nerf_mma::BM;
  static constexpr int LDX = nerf_mma::LDX;
  static constexpr long long TILE_SLOTS = (long long)nerf_mma::NACT * nerf_mma::SLOT;
  static constexpr size_t fwd_smem_bytes() { return nerf_mma::fwd_smem_bytes(); }
  static constexpr size_t bwd_smem_bytes() { return nerf_mma::bwd_smem_bytes(); }
  static __host__ __device__ constexpr int pad(int v) { return nerf_mma::pad16(v); }
  static __device__ Tiles tiles(void* smem, bool backward) {
    return nerf_mma::make_tiles(smem, backward);
  }
  static __device__ Mat fmat(const E* F, const Pack& M, int i) { return nerf_mma::fmat(F, M, i); }
  static __device__ Mat bmat(const E* Bp, const Pack& M, int i) { return nerf_mma::bmat(Bp, M, i); }
  static __device__ void ring_start(Ring& r, const Mat& m) { nerf_mma::ring_start(r, m); }
  static __device__ void load_slot(E* P, const E* slot, int width) {
    nerf_mma::load_slot(P, slot, width);
  }
  static __device__ void load_cotangent(float* GI, const float* g, int row0, int n) {
    nerf_mma::load_cotangent(GI, g, row0, n);
  }
  static __device__ void forward_tile(const Dims& dm, const Layout& L, const Pack& M, const E* F,
                                      const float* B, const Tiles& t, Ring& ring, E* keep,
                                      float* out, int row0, const Mat* after) {
    nerf_mma::forward_tile<FRESH>(dm, L, M, F, B, t, ring, keep, out, row0, after);
  }
  static __device__ void backward_walk(const Dims& dm, const Layout& L, const Pack& M,
                                       const E* Bp, const Tiles& t, Ring& ring, const E* acts,
                                       float* part, bool first, int row0, float* dx, float* dd,
                                       const Mat* after, const Mat& b10) {
    nerf_mma::backward_walk<FRESH>(dm, L, M, Bp, t, ring, acts, part, first, row0, dx, dd, after,
                                   b10);
  }
};

__host__ __device__ constexpr int rays_per_group(int S, int bm = BM) {
  return S >= bm ? 1 : bm / S;
}
// Tiles of bm rows of one group.
__host__ __device__ constexpr int tiles_per_group(int S, int bm = BM) {
  return (rays_per_group(S, bm) * S + bm - 1) / bm;
}
// Groups of (R, S), or 0 where S is not a count the kernels take.
inline int n_groups(int R, int S, int bm = BM) {
  if (S <= 0 || S > nerf_comp::MAX_S_COMP) return 0;
  const int rpg = rays_per_group(S, bm);
  return (R + rpg - 1) / rpg;
}
// Activation-slot elements (the kit's type) a block keeps for one group.
template <class K = Bf16Kit>
__host__ __device__ constexpr long long act_elems(int S) {
  return (long long)tiles_per_group(S, K::BM) * K::TILE_SLOTS;
}

template <class K = Bf16Kit>
constexpr size_t smem_bytes(int S) {
  return K::bwd_smem_bytes() +
         sizeof(float) * (size_t)rays_per_group(S, K::BM) * (9 * (size_t)S + 1);
}
template <class K = Bf16Kit>
constexpr size_t fwd_smem_bytes(int S) {
  return K::fwd_smem_bytes() + sizeof(float) * 4 * (size_t)rays_per_group(S, K::BM) * S;
}
template <class K>
constexpr size_t max_smem_bytes() {
  size_t m = 0;
  for (int S = 1; S <= nerf_comp::MAX_S_COMP; ++S)
    m = smem_bytes<K>(S) > m ? smem_bytes<K>(S) : m;
  return m;
}
static_assert(max_smem_bytes<Bf16Kit>() == smem_bytes(nerf_comp::MAX_S_COMP) &&
                  max_smem_bytes<Bf16Kit>() <= 232448,
              "the group's rows must fit beside the backward tiles");
static_assert(fwd_smem_bytes(nerf_comp::MAX_S_COMP) == 145920 && fwd_smem_bytes(128) == 139776,
              "the group's raw values beside the forward tiles");

// The rays a block owns in one step: [ray0, ray0 + n_rays), rows n_rays * S.
struct Group {
  int ray0, n_rays, rows;
};

__device__ inline Group group_at(int group, int R, int S, int bm = BM) {
  Group g;
  g.ray0 = group * rays_per_group(S, bm);
  g.n_rays = min(rays_per_group(S, bm), R - g.ray0);
  g.rows = g.n_rays * S;
  return g;
}

// The backward of the groups group = blockIdx.x, + gridDim.x, ... < n_groups
// of (R, S) rays. `Policy` (the kernel's own) provides
//   void inputs(const Group&, int r0, K::E* X, K::E* D): the X and D tiles
//       of the group's rows [r0, r0 + K::BM), rows at or past g.rows and pad
//       columns zero;
//   float composite(const Group&, int i, const float* raw, float* graw,
//       float* dzc): ray i's raw cotangent and compositing dz; returns a value
//       the loop sums over the block's rays in ray order (B5: the ray's
//       squared error);
//   static constexpr bool INPUT_GRADS: whether the input gradients are
//       outputs of the kernel (B4). Without them:
//   float dz(const Group&, int row, const float* gx, const K::E* x): the
//       points' share of row `row`'s dz from its dx (gx, xyz floats) and its X
//       row. With them:
//   float* dx_rows(const Group&, int r0): where the dx rows [r0, r0 + K::BM) of
//       the group go, (rows, xyz) f32;
//   void dd_sum(const Group&, int r0, int n, const float* dd, float& carry):
//       adds the tile's n dd rows (dir floats each, row r0 of the group first)
//       to each ray's sum; `carry` is a register of the calling thread that
//       lives from tile to tile of the group.
// `part` is the block's gradient slab, `acts` its act_elems<K>(S) slots,
// `slab` its K::BM-row f32 slab: dx rows, xyz floats each (without
// INPUT_GRADS), or dd rows, dir floats each (with; null without view dirs).
// `raw`, where not null, receives the raw values the compositing read, (R S,
// 4) f32: the checks take each sample's side of the compositing's kink
// (max(sigma, 0)) from it. Returns (in thread 0) the sum of composite's values.
template <class Policy, class K = Bf16Kit>
__device__ inline float backward_groups(const Policy& pol, void* smem, const Dims& dm,
                                        const Layout& L, const typename K::Pack& M,
                                        const typename K::E* __restrict__ F,
                                        const typename K::E* __restrict__ Bp,
                                        const float* __restrict__ B, float* part,
                                        typename K::E* acts, float* slab,
                                        float* __restrict__ dz, float* __restrict__ raw, int R,
                                        int S, int n_groups) {
  constexpr int BM = K::BM;
  const typename K::Tiles t = K::tiles(smem, true);
  const int rpg = rays_per_group(S, BM);
  float* RAW = t.GI + BM * 8;       // (rpg S, 4) raw radiance
  float* GRAW = RAW + 4 * rpg * S;  // (rpg S, 4) its cotangent
  float* DZC = GRAW + 4 * rpg * S;  // (rpg S) the compositing's dz
  float* ERR = DZC + rpg * S;       // (rpg) composite's values
  const typename K::Mat f0 = K::fmat(F, M, 0), b10 = K::bmat(Bp, M, 10);
  const int last_slot = dm.has_dir ? 8 : 9;  // the rgb branch's last post-activation
  const size_t tile_slots = (size_t)K::TILE_SLOTS;
  const int tid = threadIdx.x;
  typename K::Ring ring{t.ring, 0};
  K::ring_start(ring, f0);
  bool first = true;
  float sum = 0.f, carry = 0.f;
  for (int group = blockIdx.x; group < n_groups; group += gridDim.x) {
    const Group g = group_at(group, R, S, BM);
    const int n_tiles = (g.rows + BM - 1) / BM;
    // 1. the forward, once per row
    for (int j = 0; j < n_tiles; ++j) {
      T32_PHASE(nerf_t32ph::INPUTS);
      __syncthreads();
      pol.inputs(g, j * BM, t.X, t.D);
      __syncthreads();
      Dims tdm = dm;
      tdm.n = min(BM, g.rows - j * BM);
      K::forward_tile(tdm, L, M, F, B, t, ring, acts + j * tile_slots, RAW + 4 * j * BM, 0,
                      j + 1 < n_tiles ? &f0 : &b10);
    }
    T32_PHASE(nerf_t32ph::COMPOSITE);
    __syncthreads();
    if (raw != nullptr)
      for (int i = tid; i < 4 * g.rows; i += blockDim.x) raw[(size_t)g.ray0 * S * 4 + i] = RAW[i];
    // 2. the compositing, one thread per ray
    if (tid < g.n_rays)
      ERR[tid] = pol.composite(g, tid, RAW + (size_t)tid * S * 4, GRAW + (size_t)tid * S * 4,
                               DZC + (size_t)tid * S);
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < g.n_rays; ++i) sum += ERR[i];
    // 3. the walk over the kept slots, then dz
    for (int j = 0; j < n_tiles; ++j) {
      T32_PHASE(nerf_t32ph::INPUTS);
      const typename K::E* slots = acts + j * tile_slots;
      if (n_tiles > 1) {
        __syncthreads();
        pol.inputs(g, j * BM, t.X, t.D);
        K::load_slot(t.P, slots + last_slot * (tile_slots / nerf_mlp::NACT), K::pad(dm.last));
      }
      K::load_cotangent(t.GI, GRAW, j * BM, g.rows);
      __syncthreads();
      Dims tdm = dm;  // the tile as a call of its own: its rows from row 0
      tdm.n = min(BM, g.rows - j * BM);
      const typename K::Mat* after =
          j + 1 < n_tiles ? &b10 : group + (int)gridDim.x < n_groups ? &f0 : nullptr;
      if constexpr (Policy::INPUT_GRADS) {
        K::backward_walk(tdm, L, M, Bp, t, ring, slots, part, first, 0, pol.dx_rows(g, j * BM),
                         dm.has_dir ? slab : nullptr, after, b10);
        first = false;
        T32_PHASE(nerf_t32ph::DZ);
        __syncthreads();
        if (dm.has_dir) pol.dd_sum(g, j * BM, tdm.n, slab, carry);
        if (tid < tdm.n) dz[(size_t)g.ray0 * S + j * BM + tid] = DZC[j * BM + tid];
      } else {
        K::backward_walk(tdm, L, M, Bp, t, ring, slots, part, first, 0, slab, nullptr, after,
                         b10);
        first = false;
        T32_PHASE(nerf_t32ph::DZ);
        __syncthreads();
        if (tid < tdm.n) {
          const int row = j * BM + tid;
          dz[(size_t)g.ray0 * S + row] =
              DZC[row] + pol.dz(g, row, slab + tid * dm.xyz, t.X + tid * K::LDX);
        }
      }
    }
  }
  return sum;
}

// The forward of the groups group = blockIdx.x, + gridDim.x, ... < n_groups
// of (R, S) rays: step 1 of backward_groups without the slots, then
// `pol.composite(g, i, raw)` one thread per ray. `Policy::inputs` as
// backward_groups takes it. `raw` as there. Tile j of a group writes its raw
// rows at RAW + 4 j BM, so a ray over several tiles (f32 at S > 64) lies
// whole in RAW for its one compositing thread. Every kernel launches one
// block a group: a block's last tile then issues no next chunk.
template <class Policy, class K = Bf16Kit>
__device__ inline void forward_groups(const Policy& pol, void* smem, const Dims& dm,
                                      const Layout& L, const typename K::Pack& M,
                                      const typename K::E* __restrict__ F,
                                      const float* __restrict__ B, float* __restrict__ raw, int R,
                                      int S, int n_groups) {
  constexpr int BM = K::BM;
  const typename K::Tiles t = K::tiles(smem, false);
  float* RAW = t.sig + BM;  // (rpg S, 4) raw radiance
  const typename K::Mat f0 = K::fmat(F, M, 0);
  const int tid = threadIdx.x;
  typename K::Ring ring{t.ring, 0};
  K::ring_start(ring, f0);
  for (int group = blockIdx.x; group < n_groups; group += gridDim.x) {
    const Group g = group_at(group, R, S, BM);
    const int n_tiles = (g.rows + BM - 1) / BM;
    for (int j = 0; j < n_tiles; ++j) {
      T32_PHASE(nerf_t32ph::INPUTS);
      __syncthreads();
      pol.inputs(g, j * BM, t.X, t.D);
      __syncthreads();
      Dims tdm = dm;
      tdm.n = min(BM, g.rows - j * BM);
      const bool more = j + 1 < n_tiles || group + (int)gridDim.x < n_groups;
      K::forward_tile(tdm, L, M, F, B, t, ring, nullptr, RAW + 4 * j * BM, 0,
                      more ? &f0 : nullptr);
    }
    T32_PHASE(nerf_t32ph::COMPOSITE);
    __syncthreads();
    if (raw != nullptr)
      for (int i = tid; i < 4 * g.rows; i += blockDim.x) raw[(size_t)g.ray0 * S * 4 + i] = RAW[i];
    if (tid < g.n_rays) pol.composite(g, tid, RAW + (size_t)tid * S * 4);
  }
}

}  // namespace nerf_cmma
