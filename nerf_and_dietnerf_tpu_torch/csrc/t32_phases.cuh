// Phase stamps of the f32 tensor-core kernels (mlp_tf32_mma_tile.cuh and the
// loops that drive it), for tools/t32_phases.py. Compiled in only with
// -DNERF_T32_PHASES, which the tool passes to a build of its own in a
// directory of its own; every macro below is empty otherwise, so the
// libraries the port loads are the same code.
//
// Thread 0 of each block reads clock64() at every mark and adds the cycles
// since the last mark to the phase that was running, in shared memory.
// T32_PHASE(p) first passes a barrier, so a phase's cycles are the block's
// (every warp done with the phase before); T32_STEP(p) does not, for the
// marks inside a product's k-loop, whose own barrier closes the wait phase.
// T32_END writes the block's cycles per phase and its %globaltimer span (ns)
// to the buffer nerf_t32_phase_buffer set: (gridDim.x, T32_N + 1) u64.
//
// Cut variants, for the same tool only: -DNERF_T32_CUT=<mask> leaves out a
// part of the work (the results are then wrong) so that its cost shows as
// the time it saves: T32_CUT_OLD, the weight-gradient slab is stored, not
// added to (no old value reaches a sum); T32_CUT_LO, each 3xTF32 product runs
// its hi.hi term alone;
// T32_CUT_RING, no weight chunk is copied into the ring (its waits and
// barriers stay).
#pragma once

#include <stdint.h>

#ifndef NERF_T32_CUT
#define NERF_T32_CUT 0
#endif
#define T32_CUT_OLD 1
#define T32_CUT_LO 2
#define T32_CUT_RING 4

namespace nerf_t32ph {

enum Phase {
  INPUTS,     // X, D and cotangent tiles built or loaded
  FWD_WAIT,   // forward products: the ring's wait and barrier per chunk
  FWD_MMA,    // forward products: issue of the next chunk and the products
  FWD_EPI,    // forward: bias + leaky into P, slot stores, the narrow heads
  COMPOSITE,  // the compositing (and raw output) of a ray group
  BWD_WAIT,   // chain back: the ring's wait and barrier per chunk
  BWD_MMA,    // chain back: issue and products
  WGRAD,      // weight-gradient products A^T G, slab read and write
  NARROW,     // narrow heads: their weight, bias gradients and rank-1 terms
  GRAD,       // gradient tiles (leaky'), dx / dd rows to global memory
  SLOT,       // kept activations reloaded into P
  DZ,         // the per-row dz pass
  OTHER,      // everything else: loop control, the kernel's tail
  N_PHASES
};

}  // namespace nerf_t32ph

#ifdef NERF_T32_PHASES

#include <cuda_runtime.h>

constexpr int T32_N = nerf_t32ph::N_PHASES;
__device__ unsigned long long* t32_phase_out;
__shared__ unsigned long long t32_acc[T32_N];
__shared__ long long t32_last;
__shared__ unsigned long long t32_t0;
__shared__ int t32_cur, t32_mode;

__device__ __forceinline__ unsigned long long t32_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void t32_mark(int p) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    t32_acc[t32_cur] += (unsigned long long)(now - t32_last);
    t32_last = now;
    t32_cur = p;
  }
}
#define T32_BEGIN()                                               \
  do {                                                            \
    if (threadIdx.x == 0) {                                       \
      for (int i_ = 0; i_ < T32_N; ++i_) t32_acc[i_] = 0;         \
      t32_cur = nerf_t32ph::OTHER;                                \
      t32_mode = 0;                                               \
      t32_t0 = t32_globaltimer();                                 \
      t32_last = clock64();                                       \
    }                                                             \
    __syncthreads();                                              \
  } while (0)
#define T32_PHASE(p)   \
  do {                 \
    __syncthreads();   \
    t32_mark(p);       \
  } while (0)
#define T32_STEP(p) t32_mark(p)
// The products' wait and issue phases of the forward (0) or backward (1).
#define T32_MODE(m)                       \
  do {                                    \
    if (threadIdx.x == 0) t32_mode = (m); \
  } while (0)
#define T32_WAIT_PHASE (t32_mode ? nerf_t32ph::BWD_WAIT : nerf_t32ph::FWD_WAIT)
#define T32_MMA_PHASE (t32_mode ? nerf_t32ph::BWD_MMA : nerf_t32ph::FWD_MMA)
#define T32_END()                                                              \
  do {                                                                         \
    T32_PHASE(nerf_t32ph::OTHER);                                              \
    if (threadIdx.x == 0 && t32_phase_out != nullptr) {                        \
      unsigned long long* o_ = t32_phase_out + (size_t)blockIdx.x * (T32_N + 1); \
      for (int i_ = 0; i_ < T32_N; ++i_) o_[i_] = t32_acc[i_];                 \
      o_[T32_N] = t32_globaltimer() - t32_t0;                                  \
    }                                                                          \
  } while (0)

// Where the stamps go: (blocks, T32_N + 1) u64, or null for none.
extern "C" int nerf_t32_phase_buffer(void* out) {
  unsigned long long* p = static_cast<unsigned long long*>(out);
  return (int)cudaMemcpyToSymbol(t32_phase_out, &p, sizeof(p));
}
extern "C" int nerf_t32_phase_count() { return T32_N; }

#else

#define T32_BEGIN() \
  do {              \
  } while (0)
#define T32_PHASE(p) \
  do {               \
  } while (0)
#define T32_STEP(p) \
  do {              \
  } while (0)
#define T32_MODE(m) \
  do {              \
  } while (0)
#define T32_END() \
  do {            \
  } while (0)

#endif
