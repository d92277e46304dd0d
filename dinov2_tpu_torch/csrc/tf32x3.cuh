// 3xTF32 on Hopper's tensor cores: f32-accurate products for the f32
// kernels that are redesigned off the CUDA cores (K7's f32 GEMM,
// quant_matmul.cu; K6 f32, f32_backward.cuh).
//
// An f32 operand a is split once, where it is staged, into two TF32 values,
//
//     a_hi = tf32(a)             cvt.rna.tf32.f32 (to nearest, ties away)
//     a_lo = tf32(a - a_hi)      the subtraction is exact in f32
//
// and a . b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on wgmma
// m64nNk8.f32.tf32.tf32 (a_lo.b_lo is below f32's last bit and is dropped).
// The residual of a - (a_hi + a_lo) is at most 2^-22 of |a|, so each product
// is f32-accurate where one-pass TF32 keeps 10 mantissa bits (f32_gemm.cuh's
// note). Both planes hold whole TF32 values (low 13 bits zero), so the
// tensor cores read them as they are, whatever they do with the bits a raw
// f32 value would have.
//
// The tensor cores sum the products into the f32 accumulator with
// truncation, not to nearest (Ootomo and Yokota, "Recovering single
// precision accuracy from Tensor Cores while surpassing the FP32
// theoretical peak performance", 2022, on the A100's mma): over a long
// contraction those errors add up. So a long sum is taken in chunks: a
// chunk's three products go into a fresh accumulator (tf32x3_product with
// accumulate false), and the chunk's sum is added to the running sum with
// an f32 add, rounded to nearest, outside the tensor cores. Inside a chunk the two small
// products of every k8 step come first and the large ones after them, so
// the small terms are summed while the accumulator is still small and only
// the chunk's k8 steps of large terms meet the truncation at full size. On
// an H100 this keeps K7's f32 GEMM (32-deep chunks) and K6 f32 inside the
// port's f32 bounds (1e-5, gradients 2e-5, of max(1, max|y|)), if further
// from an f32 FFMA sum than FFMA itself (PERF.md).
//
// What bounds it on an H100: 494.7 TFLOP/s of dense TF32, three passes a
// product, so 165 TFLOP/s of f32-accurate products, 2.5x the 67 TFLOP/s of
// f32 FFMA on the CUDA cores.
//
// Operands are K-major (the only layout wgmma takes for .tf32: it has no
// transpose bit), in 128-byte-swizzled atoms of 32 floats a row: row r's
// 16-byte chunk c at byte r*128 + ((c ^ (r & 7)) * 16) of a 1024-byte
// aligned tile (wgmma_tiles.cuh's layout, which the TMA's 128-byte swizzle
// writes too). A k8 step is 32 bytes further inside a row, so a 32-deep
// contraction is one atom and a 64-deep one two atoms side by side.

#pragma once

#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kTf32AtomFloats = 32;  // floats of a 128-byte swizzle row

// x rounded to TF32 (to nearest, ties away from zero), as an f32 value
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(__fsub_rn(x, hi));
}

__device__ __forceinline__ void split_tf32(const float4& x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

#define DINOV2_ACC16(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define DINOV2_ACC16_LIST "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x N of this warpgroup) = [d +] A . B^T for one k8 step, A (64 x 8)
// and B (N x 8) K-major TF32 in shared memory; accumulate 0 overwrites d.
// d is float[N / 2] in wgmma_tiles.cuh's accumulator layout (element 4*nt +
// j is row 16*w + g + 8*(j >> 1), column 8*nt + 2*tig + (j & 1)).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " DINOV2_ACC16_LIST
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : DINOV2_ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DINOV2_ACC64_LIST
      ", %64, %65, p, 1, 1;\n"
      "}\n"
      : DINOV2_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 of this warpgroup) = [d +] A . B^T for one k8 step, A (64 x 8)
// TF32 in registers, B (64 x 8) K-major TF32 in shared memory. a is the
// mma.sync m16n8k8 .tf32 fragment of each warp's 16 rows: a[0] (row g, k
// tig), a[1] (g + 8, tig), a[2] (g, tig + 4), a[3] (g + 8, tig + 4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DINOV2_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : DINOV2_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The k8 steps of a 64 x kN product whose A comes from a wgmma accumulator
// (float[kN / 2], wgmma_tiles.cuh's layout: n-tile nt's element 4*nt + j at
// row g + 8*(j >> 1), column 8*nt + 2*tig + (j & 1)), split into hi and lo
// fragments. Step nt takes n-tile nt with its columns in the order 0, 2, 4,
// 6, 1, 3, 5, 7 (column 2*t + b at k = t + 4*b): so the accumulator's own
// registers are the fragment, and the B operand holds its k rows in that
// order within each group of eight.
template <int kN>
struct SplitFragments {
  uint32_t hi[kN / 8][4], lo[kN / 8][4];

  __device__ __forceinline__ void set(const float (&acc)[kN / 2]) {
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      const int order[4] = {0, 2, 1, 3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h, l;
        split_tf32(acc[4 * nt + order[i]], h, l);
        hi[nt][i] = __float_as_uint(h);
        lo[nt][i] = __float_as_uint(l);
      }
    }
  }
};

// d (64 x 64) = A . B^T over kN / 8 k8 steps in 3xTF32 (the small products
// of every step, then the large ones), A from registers (SplitFragments),
// B (64 rows) from its hi and lo planes, one swizzle atom of kN floats a
// row at most; a fresh chunk, started and not waited for.
template <int kN>
__device__ __forceinline__ void tf32x3_product_rs(float (&d)[32], const SplitFragments<kN>& a,
                                                  uint32_t b_hi, uint32_t b_lo) {
  static_assert(kN <= kTf32AtomFloats, "one atom of k");
#pragma unroll
  for (int s = 0; s < kN / 8; ++s) {
    wgmma_tf32_rs(d, a.lo[s], tile_descriptor(b_hi + 32 * s), s > 0);
    wgmma_tf32_rs(d, a.hi[s], tile_descriptor(b_lo + 32 * s), 1);
  }
#pragma unroll
  for (int s = 0; s < kN / 8; ++s) wgmma_tf32_rs(d, a.hi[s], tile_descriptor(b_hi + 32 * s), 1);
}

// d (64 x N) [+]= A . B^T over kSteps k8 steps in 3xTF32 (the small
// products of every step, then the large ones), started and not waited
// for. a_hi/a_lo and b_hi/b_lo are the shared addresses of the operands'
// two planes; step s lies in atom s / 4, a_atom (b_atom) bytes
// after the first, 32 * (s % 4) bytes into its rows. With accumulate false
// the first product overwrites d: a fresh chunk (see the note above).
template <int N, int kSteps>
__device__ __forceinline__ void tf32x3_product(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                               uint32_t b_hi, uint32_t b_lo, uint32_t a_atom,
                                               uint32_t b_atom, bool accumulate) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t a_at = (s >> 2) * a_atom + (s & 3) * 32;
    const uint32_t b_at = (s >> 2) * b_atom + (s & 3) * 32;
    wgmma_tf32<N>(d, tile_descriptor(a_lo + a_at), tile_descriptor(b_hi + b_at),
                  s > 0 || accumulate);
    wgmma_tf32<N>(d, tile_descriptor(a_hi + a_at), tile_descriptor(b_lo + b_at), 1);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t a_at = (s >> 2) * a_atom + (s & 3) * 32;
    const uint32_t b_at = (s >> 2) * b_atom + (s & 3) * 32;
    wgmma_tf32<N>(d, tile_descriptor(a_hi + a_at), tile_descriptor(b_hi + b_at), 1);
  }
}

// the f32 sum of a chunk into the running sum, rounded to nearest
template <int kN>
__device__ __forceinline__ void add_chunk(float (&sum)[kN], const float (&chunk)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[i] = __fadd_rn(sum[i], chunk[i]);
}

}  // namespace
}  // namespace dinov2
