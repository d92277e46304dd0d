// Shared pieces of the port's hand-written Hopper kernels: the element type,
// the 64-wide tile constants, bf16 packing and rounding helpers and a warp
// sum. wgmma_tiles.cuh (and through it the attention kernels K1 to K4, K6
// and K8 and the wgmma GEMM of K1, K2, K5, K7 and K8), gemm_core.cuh (the
// GEMM epilogues) and dequant_tile.cuh take them from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dinov2 {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;        // GEMM k-step and swizzle atom; attention query/key tile
constexpr int kThreads = 128;    // four warps
constexpr int kHeadDim = 64;

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
