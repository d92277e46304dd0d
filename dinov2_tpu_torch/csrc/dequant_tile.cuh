// Reading a ggml-quantized linear weight (models/params.py::QuantLinear)
// straight from its packed form, for K7 (quant_matmul.cu: its dequantize
// launch) and K8 (quant_layer.cu: its two dequantize launches): bf16 (N, K)
// for bf16 x, or for f32 x the two TF32 planes of the f32 weight, (2, N,
// K), the B operand of tf32x3_gemm.cuh's GEMM as it lies.
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
// one cast to the GEMM's type (none for f32; the TF32 split of tf32x3.cuh
// for the 3xTF32 GEMM of K7 f32 and K8 f32, whose planes sum to the f32 value: exactly for q4_0,
// q5_0 and q8_0, whose values have at most 19 significant bits, within
// 2^-22 of it for q4_1 and q5_1). The TPU kernel's bf16 scale rounding and
// its blocksums(x)·mᵀ correction (dinov2_tpu/ops/pallas_qmatmul.py) are MXU
// artefacts and are not copied.
//
// The Python wrappers ask packed weights for K/2 % 64 == 0 (every DINOv2
// width has it) and SoA weights for K % 64 == 0: a 16-byte piece of codes
// (dequant_weight_kernel) then lies inside one plane, and K is a whole
// number of the bf16 GEMMs' 64-deep k-steps.

#pragma once

#include "tf32x3.cuh"

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

// In dinov2's unnamed namespace, as every kernel in a header: each library
// that includes it gets its own copy, and a .cu's own kernels go in the same
// namespace (a second unnamed namespace at file scope makes nvcc's host
// stubs ambiguous).
namespace {

constexpr int kDequantThreads = 256;

// The value of code q times scale, plus mn where the format has m (mins
// not null), rounded in f32 without fused multiply-add: dequant_weight's
// arithmetic.
__device__ __forceinline__ float dequant_value(int q, float scale, const float* mins, float mn) {
  const float v = __fmul_rn(static_cast<float>(q), scale);
  return mins ? __fadd_rn(v, mn) : v;
}

// Where dequant_weight_kernel writes an (N, K) weight's values: bf16 rows,
// the compute type of K7's and K8's bf16 GEMMs, two 16-byte pieces for 16
// values.
struct Bf16Rows {
  bf16* out;

  __device__ __forceinline__ void store16(size_t at, const int (&q)[16], float scale,
                                          const float* mins, float mn) const {
    uint4 piece[2];
    bf16* e = reinterpret_cast<bf16*>(piece);
#pragma unroll
    for (int i = 0; i < 16; ++i) e[i] = __float2bfloat16(dequant_value(q[i], scale, mins, mn));
    reinterpret_cast<uint4*>(out + at)[0] = piece[0];
    reinterpret_cast<uint4*>(out + at)[1] = piece[1];
  }
};

// ... or the two TF32 planes of the f32 values, (2, N, K): hi = tf32(v) at
// plane 0, lo = tf32(v - hi) at plane 1 (`plane` floats on), the B operand
// of the 3xTF32 GEMM (K7 f32, K8 f32) as it lies.
struct Tf32SplitRows {
  float* out;
  size_t plane;

  __device__ __forceinline__ void store16(size_t at, const int (&q)[16], float scale,
                                          const float* mins, float mn) const {
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      float4 hi, lo;
      split_tf32(make_float4(dequant_value(q[i], scale, mins, mn),
                             dequant_value(q[i + 1], scale, mins, mn),
                             dequant_value(q[i + 2], scale, mins, mn),
                             dequant_value(q[i + 3], scale, mins, mn)),
                 hi, lo);
      *reinterpret_cast<float4*>(out + at + i) = hi;
      *reinterpret_cast<float4*>(out + plane + at + i) = lo;
    }
  }
};

// W (N, K) = dequant(W) into `rows`: a thread a 16-byte piece of codes, that
// is 16 values of an int8 SoA row, or 16 bytes of a packed row, whose low
// nibbles are values j0..j0+15 and high nibbles values K/2+j0..K/2+j0+15.
template <class Rows>
__global__ void __launch_bounds__(kDequantThreads)
    dequant_weight_kernel(QuantWeight w, Rows rows) {
  const int row_bytes = w.packed ? w.k / 2 : w.k;
  const int pieces = row_bytes / 16;
  const size_t piece = static_cast<size_t>(blockIdx.x) * kDequantThreads + threadIdx.x;
  if (piece >= static_cast<size_t>(w.n) * pieces) return;
  const int row = static_cast<int>(piece / pieces);
  const int j0 = static_cast<int>(piece % pieces) * 16;
  const uint4 raw =
      __ldg(reinterpret_cast<const uint4*>(w.codes + static_cast<size_t>(row) * row_bytes + j0));
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
  const size_t row_blocks = static_cast<size_t>(row) * (w.k >> 5);
  const size_t dst = static_cast<size_t>(row) * w.k;
  int q[16];
  if (!w.packed) {
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = static_cast<int8_t>(bytes[i]);
    const size_t blk = row_blocks + (j0 >> 5);
    rows.store16(dst + j0, q, __ldg(w.d + blk), w.m, w.m ? __ldg(w.m + blk) : 0.f);
    return;
  }
#pragma unroll
  for (int high = 0; high < 2; ++high) {
    uint32_t bits = 0;  // the 5th bits of the 16 values, bit i for value i
    if (w.qh_lo) {
      const uint8_t* qh =
          (high ? w.qh_hi : w.qh_lo) + static_cast<size_t>(row) * (row_bytes >> 3) + (j0 >> 3);
      bits = __ldg(qh) | (static_cast<uint32_t>(__ldg(qh + 1)) << 8);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t nibble = high ? bytes[i] >> 4 : bytes[i] & 0xFu;
      q[i] = static_cast<int>(nibble | (((bits >> i) & 1u) << 4)) - w.zero;
    }
    const int k0 = j0 + high * row_bytes;
    const size_t blk = row_blocks + (k0 >> 5);
    rows.store16(dst + k0, q, __ldg(w.d + blk), w.m, w.m ? __ldg(w.m + blk) : 0.f);
  }
}

template <class Rows>
cudaError_t launch_dequant_rows(const QuantWeight& w, Rows rows, cudaStream_t s) {
  const size_t pieces = static_cast<size_t>(w.n) * ((w.packed ? w.k / 2 : w.k) / 16);
  const unsigned blocks = static_cast<unsigned>((pieces + kDequantThreads - 1) / kDequantThreads);
  dequant_weight_kernel<<<blocks, kDequantThreads, 0, s>>>(w, rows);
  return cudaGetLastError();
}

// W (N, K) bf16 = dequant(W), bit for bit dequant_weight(W, bf16)
cudaError_t launch_dequant_weight(const QuantWeight& w, bf16* out, cudaStream_t s) {
  return launch_dequant_rows(w, Bf16Rows{out}, s);
}

// planes (2, N, K) f32 = the TF32 hi and lo planes of dequant_weight(W, f32)
cudaError_t launch_dequant_weight_split(const QuantWeight& w, float* planes, cudaStream_t s) {
  return launch_dequant_rows(
      w, Tf32SplitRows{planes, static_cast<size_t>(w.n) * static_cast<size_t>(w.k)}, s);
}

}  // namespace
}  // namespace dinov2
