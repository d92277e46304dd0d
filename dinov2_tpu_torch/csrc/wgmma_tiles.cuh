// Hopper building blocks of the flash-attention kernels (K4,
// flash_attention.cu; K6, flash_backward.cu): 128-byte-swizzled shared tiles
// filled by cp.async, and warpgroup matrix products (wgmma) on them.
//
// A tile is a run of head rows: one row of head_dim 64 bf16 is 128 bytes, one
// swizzle row. Row r, 16-byte chunk c lies at byte r*128 + ((c ^ (r & 7)) * 16)
// of a 1024-byte aligned tile, the layout wgmma's 128B-swizzle descriptors
// read. The same bytes serve both uses of a tile:
//   - as the "k-major" operand of x . tile^T (contraction over head_dim, the
//     q k^T pattern): one k16 step is 32 bytes further inside the swizzle row;
//   - as the "mn-major" B operand of w . tile (contraction over the tile's
//     rows, the p v pattern): the descriptor's transpose bit, no transposed
//     copy and no scalar loads; one k16 step is 16 rows = 2048 bytes further.
// Both read 8-row groups 1024 bytes apart (the stride byte offset).
//
// A warpgroup (four warps) owns 64 rows of a product. Accumulators are
// float[32]: for warp w of the warpgroup and lane = 4*g + tig, element
// 4*nt + j is row 16*w + g + 8*(j >> 1), column 8*nt + 2*tig + (j & 1), the
// mma.sync m16n8 layout stacked, so a 64 x 64 accumulator rounded to bf16 is
// directly the register A operand of the next product.

#pragma once

#include <atomic>

#include "attention_core.cuh"

namespace dinov2 {

constexpr int kRowBytes = kHeadDim * 2;          // 128
constexpr int kTileBytes = kTile * kRowBytes;    // a 64-row tile: 8192
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid (the
// source is then not read, but must be an address of the tensor).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// makes this thread's shared-memory writes (cp.async included) visible to
// wgmma, which reads shared memory through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows r0..r0+kRows-1 of a head's (T, 64) matrix (`ld` elements a row) into
// the swizzled tile at shared address dst, by all kThreadsN threads of the
// block; rows past T are zero-filled. A thread copies chunk (tid & 7) of rows
// tid / 8 + s * kThreadsN / 8: the rows are a multiple of 8 apart, so its
// swizzled chunk is the same in each and a copy costs a compare and two adds.
// The caller commits the group.
template <int kRows, int kThreadsN>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src,
                                                size_t ld, int r0, int t) {
  static_assert(kRows * 8 % kThreadsN == 0 && kThreadsN % 64 == 0, "whole steps of whole groups");
  constexpr int kSteps = kRows * 8 / kThreadsN, kRowStep = kThreadsN / 8;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const uint32_t dst_t = dst + swizzled(r, c);
  const bf16* src_t = src + static_cast<size_t>(r0 + r) * ld + c * 8;
  const size_t step = static_cast<size_t>(kRowStep) * ld;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const bool valid = r0 + r + s * kRowStep < t;
    cp_async_16(dst_t + s * kRowStep * kRowBytes, valid ? src_t + s * step : src, valid);
  }
}

// The shared-memory matrix descriptor of a swizzled tile (or of a point
// inside it: see the k16 steps above): 128-byte swizzle, 8-row groups 1024
// bytes apart; the leading byte offset is not used by either operand form at
// 64 columns.
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t address) {
  return static_cast<uint64_t>((address & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// the named barrier `id` (1..15; 0 is __syncthreads') over `threads`
// threads, whole warps
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: the compiler
// moves no use of them across this point.
template <int kN>
__device__ __forceinline__ void fence_registers(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_registers(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DINOV2_ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DINOV2_ACC32_LIST                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define DINOV2_ACC64(d)                                                                        \
  DINOV2_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),            \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),            \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),            \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define DINOV2_ACC64_LIST                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64 of this warpgroup) = [d +] A . B^T for one k16 step: A and B
// both k-major in shared memory. kAccumulate false overwrites d.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DINOV2_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : DINOV2_ACC32(d)
      : "l"(a), "l"(b), "r"(kAccumulate ? 1 : 0));
}

// d += A . B for one k16 step: A (64 x 16) in registers (the mma.sync A
// fragment of each warp's 16 rows), B (16 x 64) mn-major in shared memory.
__device__ __forceinline__ void wgmma_64x64x16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DINOV2_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : DINOV2_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc = a . b^T over head_dim: a and b are 64-row swizzled tiles (the
// warpgroup's 64 rows of a, 64 rows of b); four k16 steps, started and not waited for.
__device__ __forceinline__ void start_product_nt(float (&acc)[32], uint32_t a, uint32_t b) {
  const uint64_t da = tile_descriptor(a), db = tile_descriptor(b);
  wgmma_64x64x16_ss<false>(acc, da, db);
#pragma unroll
  for (int kc = 1; kc < 4; ++kc) wgmma_64x64x16_ss<true>(acc, da + 2 * kc, db + 2 * kc);
}

// two floats -> two bf16 (round to nearest even) in one register, lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// A 64 x 64 accumulator rounded to bf16 as the register A operand of the
// next product: a[4*kc..4*kc+3] is the fragment of k16 step kc.
__device__ __forceinline__ void round_to_operand(uint32_t (&a)[16], const float (&w)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16x2(w[2 * i], w[2 * i + 1]);
}

// acc += a . b over b's 64 rows: a from round_to_operand, b a 64-row
// swizzled tile; four k16 steps, started and not waited for.
__device__ __forceinline__ void start_product_nn(float (&acc)[32], const uint32_t (&a)[16],
                                                 uint32_t b) {
  const uint64_t db = tile_descriptor(b);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t frag[4] = {a[4 * kc], a[4 * kc + 1], a[4 * kc + 2], a[4 * kc + 3]};
    wgmma_64x64x16_rs(acc, frag, db + 128 * kc);
  }
}

// 2^x with results below 2^-126 flushed to 0: one MUFU instruction
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This warp's rows of a 64 x 64 f32 accumulator -> bf16 rows row0.. of a
// head's (T, 64) output (`ld` elements a row), each scaled by inv[h] (h = 0
// for row g, 1 for row g + 8); rows past T are skipped. `warp` counts within
// the warpgroup.
__device__ __forceinline__ void store_accumulator(bf16* __restrict__ dst, size_t ld, int row0,
                                                  int t, const float (&acc)[32],
                                                  const float (&inv)[2], int warp, int g,
                                                  int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    if (row >= t) continue;
    bf16* p = dst + row * ld + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(p + nt * 8) =
          pack_bf16x2(acc[4 * nt + 2 * h] * inv[h], acc[4 * nt + 2 * h + 1] * inv[h]);
    }
  }
}

// Dynamic shared memory above 48 KB must be granted to a kernel by
// cudaFuncSetAttribute, which holds for one device. A launcher keeps one of
// these as a function-local static, so each instantiation asks once per
// device and a launch afterwards costs a cudaGetDevice and a load.
struct SharedMemoryGrant {
  static constexpr int kMaxDevices = 64;
  std::atomic<bool> granted[kMaxDevices] = {};

  template <typename Kernel>
  cudaError_t operator()(Kernel kernel, int bytes) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const bool counted = device >= 0 && device < kMaxDevices;
    if (counted && granted[device].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && counted) granted[device].store(true, std::memory_order_release);
    return err;
  }
};

}  // namespace dinov2
