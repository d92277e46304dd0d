// The activations of the port's GEMM epilogues, shared by K7
// (quant_matmul.cu) and K5 (slab_mlp.cu): applied in f32 to a value that
// was already rounded to the compute dtype, and rounded again by the caller.

#pragma once

#include <cuda_fp16.h>
#include <math.h>

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

}  // namespace dinov2
