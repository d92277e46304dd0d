// The activations of the port's GEMM epilogues, shared by K7
// (quant_matmul.cu), K5 (slab_mlp.cu) and K9 (int8_matmul.cu): applied in
// f32 to a value that was already rounded to the compute dtype, and rounded
// again by the caller. K9's bf16 epilogue looks gelu_tanh_f16 up in a table
// instead (below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace dinov2 {

enum Activation { kNone = 0, kGeluTanhF16 = 1, kGeluErf = 2, kGeluTanh = 3 };

// PyTorch's CUDA formula for gelu(approximate="tanh") in f32; kBeta is its
// float(M_SQRT2 * M_2_SQRTPI * 0.5) = sqrt(2 / pi)
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float round_f16(float v) {
  return __half2float(__float2half_rn(v));
}

// gelu_tanh_f16 is ggml's fp16-table GELU: f16(gelu_tanh(f16(y)))
__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kGeluTanhF16:
      return round_f16(gelu_tanh(round_f16(y)));
    case kGeluErf:
      return y * 0.5f * (1.f + erff(y * 0.7071067811865476f));  // PyTorch's: 1/sqrt(2)
    case kGeluTanh:
      return gelu_tanh(y);
    default:
      return y;
  }
}

// gelu_tanh_f16 of a bf16 value, by table. The function depends on f16(y)
// alone, and a bf16 y has 2^16 bit patterns, so it is a finite table; only
// the magnitudes [kGeluTableLo, kGeluTableHi) need entries, for each sign:
//   - below 2^-25 (bf16 bits 0x3300) f16(y) is +-0 and so is the result;
//   - from 8 (0x4100) on, tanhf of the inner term is +-1 in f32, so the
//     formula gives f16(y) itself for y > 0 (inf past 65504, a NaN stays
//     one) and -0 for y < 0 while f16(y) is finite; from 65536 (0x4780)
//     f16(y) is -inf and the result NaN (-inf * 0), as for a NaN.
// Entry i holds the bf16 bits of the formula's own result (activate, then
// the round to bf16 the epilogue does), made on the card by
// gelu_tanh_f16_entry, so the lookup is the formula bit for bit.
constexpr uint32_t kGeluTableLo = 0x3300u;  // 2^-25
constexpr uint32_t kGeluTableHi = 0x4100u;  // 8.0
constexpr uint32_t kGeluTableSpan = kGeluTableHi - kGeluTableLo;  // 3584 a sign
constexpr int kGeluTableEntries = 2 * kGeluTableSpan;            // positive, then negative
constexpr uint32_t kF16Overflow = 0x4780u;  // bf16 65536: f16 rounds it to inf

__device__ __forceinline__ uint16_t gelu_tanh_f16_entry(int i) {
  const uint32_t sign = i >= static_cast<int>(kGeluTableSpan) ? 0x8000u : 0u;
  const uint32_t mag = kGeluTableLo + static_cast<uint32_t>(i) % kGeluTableSpan;
  const float g = activate(__uint_as_float((sign | mag) << 16), kGeluTanhF16);
  return __bfloat16_as_ushort(__float2bfloat16(g));
}

// y holds a bf16 value (its low 16 bits zero); returns the bf16
// gelu_tanh_f16(y) as an f32. No branch: the table is read at a clamped
// index and the closed forms are selected, with no conversion.
__device__ __forceinline__ float gelu_tanh_f16_lookup(float y, const uint16_t* table) {
  const uint32_t bits = __float_as_uint(y) >> 16;
  const uint32_t sign = bits & 0x8000u, mag = bits & 0x7fffu;
  const uint32_t at = min(max(mag, kGeluTableLo), kGeluTableHi - 1) - kGeluTableLo +
                      (sign ? kGeluTableSpan : 0u);
  const uint32_t entry = table[at];
  // above the table f16(y) is y itself (8 significant bits fit f16's 11),
  // inf from 65536 on; a NaN stays one
  const uint32_t nan = 0x7fc0u, inf = 0x7f80u;
  const uint32_t above = sign ? (mag >= kF16Overflow ? nan : 0x8000u)
                              : (mag > inf ? nan : (mag >= kF16Overflow ? inf : bits));
  const uint32_t out = mag < kGeluTableLo ? sign : (mag < kGeluTableHi ? entry : above);
  return __uint_as_float(out << 16);
}

// gelu_tanh_f16_lookup on kN values of each lane of a converged warp: when
// every value of the warp lies in the table (the common case) by the
// entry alone, else value by value with the closed forms.
template <int kN>
__device__ __forceinline__ void gelu_tanh_f16_lookup_warp(float (&y)[kN], const uint16_t* table) {
  uint32_t at[kN];
  bool inside = true;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const uint32_t bits = __float_as_uint(y[i]) >> 16;
    const uint32_t off = (bits & 0x7fffu) - kGeluTableLo;  // wraps below the table
    inside = inside && off < kGeluTableSpan;
    at[i] = off + (bits >> 15) * kGeluTableSpan;
  }
  if (__all_sync(0xffffffffu, inside)) {
#pragma unroll
    for (int i = 0; i < kN; ++i) y[i] = __uint_as_float(static_cast<uint32_t>(table[at[i]]) << 16);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) y[i] = gelu_tanh_f16_lookup(y[i], table);
  }
}

}  // namespace dinov2
