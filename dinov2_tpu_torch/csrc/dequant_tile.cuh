// Reading a ggml-quantized linear weight (models/params.py::QuantLinear)
// straight from its packed form, for K7 (quant_matmul.cu: its dequantize
// kernel and its f32 kernel) and K8 (quant_layer.cu: its GEMMs' loader).
//
// Layouts, as the loader writes them (QuantLinear's docstring):
//   packed (q4_0/q4_1/q5_0/q5_1): codes (N, K/2) u8 natural-order planes,
//     byte j of a row = element j (low nibble) | element j + K/2 (high
//     nibble); q5's 5th bits in qh_lo/qh_hi (N, K/16) u8, bit i of word g =
//     plane lane 8g + i; the zero point (8 for q4_0, 16 for q5_0) is
//     subtracted here;
//   int8 SoA (any format): codes (N, K) int8, zero point already
//     subtracted.
// Both: d and m (N, K/32) f32, m null for the symmetric formats.
//
// Numerics are ops/qmatmul.py::dequant_weight's, bit for bit: the integer
// code to f32, times d, plus m, each rounded in f32 (explicit __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into one fused multiply-add), then
// one cast to the GEMM's type. The TPU kernel's bf16 scale rounding and its
// blocksums(x)·mᵀ correction (dinov2_tpu/ops/pallas_qmatmul.py) are MXU
// artefacts and are not copied.
//
// A 64-wide k-step must lie inside one plane, so packed weights need
// K/2 % 64 == 0 (every DINOv2 width has it); SoA weights need K % 64 == 0.
// The Python wrappers check both.

#pragma once

#include "gemm_core.cuh"

namespace dinov2 {

struct QuantWeight {
  const uint8_t* codes;  // packed u8 planes, or SoA int8 codes as bytes
  const float* d;
  const float* m;        // null: symmetric format
  const uint8_t* qh_lo;  // null: no 5th bits (q4, or SoA)
  const uint8_t* qh_hi;
  int n, k;
  int packed;
  int zero;  // subtracted from packed codes

  // Elements k0..k0+7 (k0 % 8 == 0) of row `row`, dequantized to f32.
  __device__ __forceinline__ void dequant8(int row, int k0, float (&v)[8]) const {
    const size_t blk = static_cast<size_t>(row) * (k >> 5) + (k0 >> 5);
    const float scale = __ldg(d + blk);
    int q[8];
    if (packed) {
      const int half = k >> 1;
      const bool high = k0 >= half;
      const int j0 = high ? k0 - half : k0;
      const uint2 bytes =
          __ldg(reinterpret_cast<const uint2*>(codes + static_cast<size_t>(row) * half + j0));
      uint32_t bits = 0;
      if (qh_lo) {
        bits = __ldg((high ? qh_hi : qh_lo) + static_cast<size_t>(row) * (half >> 3) + (j0 >> 3));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = ((i < 4 ? bytes.x : bytes.y) >> (8 * (i & 3))) & 0xFFu;
        const uint32_t nibble = high ? byte >> 4 : byte & 0xFu;
        q[i] = static_cast<int>(nibble | (((bits >> i) & 1u) << 4)) - zero;
      }
    } else {
      const uint2 bytes =
          __ldg(reinterpret_cast<const uint2*>(codes + static_cast<size_t>(row) * k + k0));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        q[i] = static_cast<int8_t>(((i < 4 ? bytes.x : bytes.y) >> (8 * (i & 3))) & 0xFFu);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(static_cast<float>(q[i]), scale);
    if (m) {
      const float mn = __ldg(m + blk);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], mn);
    }
  }
};

// A QuantWeight from a C entry point's arguments, as the Python wrappers pass
// them (ops/qmatmul_kernel.py::quant_weight_args).
inline QuantWeight quant_weight(const void* codes, const void* d, const void* mins,
                                const void* qh_lo, const void* qh_hi, int packed, int zero,
                                int n, int k) {
  return {static_cast<const uint8_t*>(codes), static_cast<const float*>(d),
          static_cast<const float*>(mins), static_cast<const uint8_t*>(qh_lo),
          static_cast<const uint8_t*>(qh_hi), n, k, packed, zero};
}

// gemm_core.cuh's weight loader for a QuantWeight (K8): tile row r is output
// column col0 + r (zero past N), staged as ws[n][k] in bf16.
struct QuantWeightTile {
  QuantWeight w;

  __device__ __forceinline__ void store8(bf16 (&ws)[kTile][kLds], int r, int c, int k0,
                                         int col0) const {
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    const int row = col0 + r;
    if (row < w.n) {
      float v[8];
      w.dequant8(row, k0 + c, v);
      bf16* e = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);
    }
    *reinterpret_cast<uint4*>(&ws[r][c]) = out;
  }
};

}  // namespace dinov2
