// bf16 `wgmma` on Hopper: the product, the B operand's shared-memory layout
// and its descriptor, and the step from a layer's accumulator to the next
// layer's A fragments.
//
// A warpgroup (four warps, 128 threads) issues
// `wgmma.mma_async.m64n256k16.f32.bf16.bf16`: D (64 x 256 f32, in registers)
// = A (64 x 16 bf16, in registers) x B (16 x 256 bf16, in shared memory, read
// through a descriptor), plus D unless scale-d is 0.
//
// Fragments. Warp w of the warpgroup owns rows 16 w .. 16 w + 15; lane l has
// g = l / 4, t = l % 4.
// - A (four 32-bit registers, two bf16 each, the low half first): a[0] row
//   g, columns 2t and 2t + 1 of the k-step; a[1] row g + 8, the same
//   columns; a[2] row g, columns 2t + 8, 2t + 9; a[3] row g + 8, those.
//   This is the A layout of `mma.sync.m16n8k16`.
// - D (N / 2 floats): n-tile j (columns 8 j .. 8 j + 7) in d[4 j .. 4 j + 3],
//   d[4 j + 2 h + e] at row g + 8 h, column 8 j + 2 t + e: the C layout of
//   `mma.sync.m16n8k16`, n-tile by n-tile.
// So n-tiles 2 kk and 2 kk + 1 of one product's D are, thread by thread,
// k-step kk's A fragment of the next product (acc_to_frags): a chain of
// products keeps its activations in registers and never stores them.
//
// B layout (K-major, no swizzle). The operand is W^T, N rows (outputs) by
// K columns (contraction), cut into k-steps of 16 columns. A k-step holds N
// x 16 bf16 as core matrices of 8 rows x 8 columns, each 128 contiguous
// bytes (row r at 16 r bytes): the two core matrices of an 8-row group side
// by side (leading byte offset 128, the next one along K), the 8-row groups
// 256 bytes apart (stride byte offset), the k-steps N x 32 bytes apart. A
// core matrix is 128 contiguous bytes, so the tensor cores read it from all
// 32 banks once. kmajor_offset gives an entry's place; a wrapper builds the
// layout in global memory and one bulk copy a k-step moves it as it is.
//
// The mbarrier, bulk-copy, `wgmma` fence / commit / wait and descriptor
// helpers are those of the f32 forward tile (mlp_tf32_tile.cuh), whose
// descriptor (no swizzle, leading byte offset 128) reads a 16-byte core
// matrix row whatever the operand type.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mlp_tf32_tile.cuh"

namespace nerf_wgmma {

using nerf_tf32::bulk_copy;
using nerf_tf32::fence_acc;
using nerf_tf32::make_desc;
using nerf_tf32::mbar_expect_tx;
using nerf_tf32::mbar_init;
using nerf_tf32::mbar_wait;
using nerf_tf32::saddr;
using nerf_tf32::wgmma_commit;
using nerf_tf32::wgmma_fence;
using nerf_tf32::wgmma_wait_all;

constexpr int KSTEP = 16;                 // contraction columns of one bf16 `wgmma`
constexpr uint32_t GROUP_BYTES = 256;     // stride byte offset: the next 8-row group

// Bytes of one k-step of an operand with n rows.
__host__ __device__ constexpr uint32_t kstep_bytes(int n) { return 32u * n; }

// Element offset of entry (n, k) of W^T in the layout above (np rows).
__host__ __device__ constexpr int kmajor_offset(int n, int k, int np) {
  return (k / KSTEP) * np * KSTEP + (n / 8) * 128 + ((k % KSTEP) / 8) * 64 + (n % 8) * 8 + k % 8;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d (64 x 256 f32) = A (fragment a, 64 x 16 bf16) x B (K-major at desc) +
// (scale_d != 0 ? d : 0). Asynchronous: issue between wgmma_fence and
// wgmma_commit, read d only after wgmma_wait_all and fence_acc(d).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The next product's A fragments from an accumulator of n columns (N / 16
// k-steps): a[kk][i] = f(the two entries of n-tile 2 kk + i / 2 in row
// g + 8 (i % 2)), f taking the two floats and returning their packed bf16x2.
template <int N, class F>
__device__ __forceinline__ void acc_to_frags(const float (&d)[N / 2], uint32_t (&a)[N / 16][4],
                                             F f) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = f(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

}  // namespace nerf_wgmma
