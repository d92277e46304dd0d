// Shared pieces of the port's hand-written Hopper kernels: the element type,
// the 64-wide tile constants, bf16 packing and rounding helpers, a warp sum
// and mma.sync m16n8k16. wgmma_tiles.cuh (and through it the attention
// kernels K1 to K4, K6 and K8 and the wgmma GEMM of K1, K2, K5 and K7) and
// gemm_core.cuh (K8's mma.sync GEMM) take them from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dinov2 {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;        // GEMM tile rows/cols/depth; attention query/key tile
constexpr int kLds = kTile + 8;  // shared row stride in elements (144 B): conflict-free fragment loads
constexpr int kThreads = 128;    // four warps
constexpr int kHeadDim = 64;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 as one 32-bit register (lower address in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  return pack_pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace dinov2
