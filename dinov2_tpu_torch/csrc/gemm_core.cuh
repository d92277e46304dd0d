// The epilogues of the port's GEMMs (csrc/wgmma_gemm.cuh): what the
// products of an output tile become on their way to device memory, with the
// JAX package's rounding points. K1's and K8's QKV launch take
// BiasEpilogue; K1's, K2's and K8's proj and K5's fc2 ResidualEpilogue; K5's
// fc1 and K7 ActEpilogue. The GEMM hands an epilogue the accumulator in two
// steps:
//
//   col = ep.column(c): what the output columns c and c + 1 (c even) share
//     across rows (their bias), once per accumulator column pair;
//   ep.pair(c, col, a0, a1): the finished values of the columns c and c + 1
//     of one row, as two packed bf16;
//   ep.store8(row, c, v): eight finished values at row `row`, columns
//     c..c + 7 (c % 8 == 0), gathered by the GEMM into one 16-byte piece,
//     written out (with the residual added, for ResidualEpilogue).
//
// Every product in the port's kernels runs on wgmma.

#pragma once

#include "activation.cuh"
#include "attention_core.cuh"

namespace dinov2 {

// bf16(bias) of the columns c and c + 1
struct BiasPair {
  float b0, b1;
};

// out (M, N) = bf16(acc) + bf16(bias), N a multiple of 64.
struct BiasEpilogue {
  const float* bias;
  bf16* out;
  int n;

  __device__ __forceinline__ BiasPair column(int c) const {
    return {round_bf16(bias[c]), round_bf16(bias[c + 1])};
  }

  __device__ __forceinline__ uint32_t pair(int, const BiasPair& col, float a0, float a1) const {
    return pack_floats(round_bf16(a0) + col.b0, round_bf16(a1) + col.b1);
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n + c) = v;
  }
};

// out = resid + bf16(y * bf16(ls)) with y = bf16(acc) + bf16(bias), each
// step rounded to bf16; N a multiple of 64.
struct ResidualEpilogue {
  const float* bias;
  const float* ls;
  const bf16* resid;
  bf16* out;
  int n;

  __device__ __forceinline__ BiasPair column(int c) const {
    return {round_bf16(bias[c]), round_bf16(bias[c + 1])};
  }

  // bf16(y * bf16(ls)) of the columns c and c + 1; the residual is added
  // to eight of them at once in store8.
  __device__ __forceinline__ uint32_t pair(int c, const BiasPair& col, float a0, float a1) const {
    const float y0 = round_bf16(round_bf16(a0) + col.b0);
    const float y1 = round_bf16(round_bf16(a1) + col.b1);
    return pack_floats(y0 * round_bf16(ls[c]), y1 * round_bf16(ls[c + 1]));
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    const size_t at = static_cast<size_t>(row) * n + c;
    const uint4 x = *reinterpret_cast<const uint4*>(resid + at);
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ve = reinterpret_cast<const bf16*>(&v);
    uint4 y;
    uint32_t* ye = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ye[i] = pack_floats(__bfloat162float(xe[2 * i]) + __bfloat162float(ve[2 * i]),
                          __bfloat162float(xe[2 * i + 1]) + __bfloat162float(ve[2 * i + 1]));
    }
    *reinterpret_cast<uint4*>(out + at) = y;
  }
};

// out (M, N) = act(bf16(acc) + bf16(bias)), the activation kAct
// (activation.cuh) in f32 on the bf16 value and rounded once more; bias may
// be null (no add). Any N >= 1: the columns past N are computed and not
// written, and a row of a width N % 8 != 0 is not 16-byte aligned, so it is
// written value by value. The activation is a template parameter, and the
// C entries switch on the runtime code once per launch: the activation's code as a runtime switch
// inside the epilogue's loop over 64 accumulator values made K5 14% and K7
// at fc1 20% slower than with it fixed at compile time, on an H100
// (scripts/compare_kernel_builds.py against a copy so changed).
template <int kAct>
struct ActEpilogue {
  const float* bias;
  bf16* out;
  int n;

  // bf16(bias) of the columns c and c + 1 that exist, else 0 (no bias add)
  __device__ __forceinline__ BiasPair column(int c) const {
    BiasPair col{0.f, 0.f};
    if (bias && c < n) col.b0 = round_bf16(bias[c]);
    if (bias && c + 1 < n) col.b1 = round_bf16(bias[c + 1]);
    return col;
  }

  __device__ __forceinline__ uint32_t pair(int, const BiasPair& col, float a0, float a1) const {
    float y0 = round_bf16(a0), y1 = round_bf16(a1);
    if (bias) {
      y0 = round_bf16(y0 + col.b0);
      y1 = round_bf16(y1 + col.b1);
    }
    return pack_floats(activate(y0, kAct), activate(y1, kAct));
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    bf16* dst = out + static_cast<size_t>(row) * n + c;
    if ((n & 7) == 0) {
      if (c < n) *reinterpret_cast<uint4*>(dst) = v;
      return;
    }
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c + i < n) dst[i] = e[i];
    }
  }
};

}  // namespace dinov2
