// Hopper's asynchronous copy pieces for the port's persistent,
// warp-specialised GEMMs (K9's s8 GEMM, int8_matmul.cu; the f32 kernels'
// 3xTF32 GEMM, tf32x3_gemm.cuh): shared-memory
// barriers (mbarrier) that count both arrivals and the bytes a tensor copy
// lands, 2-D tensor copies global -> shared (cp.async.bulk.tensor, the
// Tensor Memory Accelerator), warpgroup register reallocation (setmaxnreg),
// and the host helper that describes a row-major int8 or f32 matrix to the
// copy engine (a CUtensorMap).
//
// A ring stage is filled by one thread of a producer warp: it waits for the
// stage's "empty" barrier (its consumers are done with the last bytes it
// held), arms the "full" barrier with the bytes to expect, and starts the
// copies, which arrive on that barrier as they land. Consumers wait on
// "full" and arrive on "empty" when their products have read the stage.
// Parity: a barrier starts in phase 0; waiting with parity p returns once
// the phase of parity p has completed, so a producer's first pass over the
// ring waits with parity 1 and goes through.
//
// The tensor map is encoded by libcuda's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so that the library links against the
// CUDA runtime alone (no -lcuda). <cuda.h> is included for the map's type
// and its enums only.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dinov2 {
namespace {

__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the copy engine and to the
// other threads; then a __syncthreads before their first use
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// whether the phase of the given parity has completed (the thread may be
// suspended for a while inside the test)
__device__ __forceinline__ bool mbarrier_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait no phase ends traps (a launch failure the wrapper raises) instead
// of holding the card: no wait of a correct pipeline comes near this.
constexpr uint64_t kBarrierTimeoutNs = 10ull * 1000 * 1000 * 1000;

// until the phase of the given parity has completed
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  if (mbarrier_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbarrier_try_wait(bar, parity)) {
    if (global_ns() - start > kBarrierTimeoutNs) __trap();
  }
}

// the box at (c0 inner, c1 outer) of the tensor `map` describes into
// shared memory at dst (1024-byte aligned for the 128-byte swizzle); its
// bytes arrive on the barrier bar. Rows and columns past the tensor's
// bounds land as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A warpgroup's registers a thread, taken or given back; all four warps of
// the warpgroup execute it, on a path that never reconverges with another
// role's (ptxas ignores it otherwise: C7508).
template <int kRegisters>
__device__ __forceinline__ void warpgroup_registers_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegisters));
}

template <int kRegisters>
__device__ __forceinline__ void warpgroup_registers_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegisters));
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once; null where it is
// missing
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major (rows, cols) matrix of `elem_bytes`-byte elements
// of `type` at `data` (16-byte aligned, rows of a multiple of 16 bytes),
// read in boxes of box_rows rows x 128 bytes, with the 128-byte swizzle
// wgmma's descriptors read (row r's 16-byte chunk c at chunk c ^ (r & 7));
// out-of-bounds rows and columns fill with zeros.
inline cudaError_t encode_rows(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                               const void* data, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  // bytes from row to row
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(data), dims, strides, box,
                              element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major (rows, cols) int8 matrix, cols % 16 == 0: boxes of 128 codes
inline cudaError_t encode_int8_rows(CUtensorMap* map, const void* data, int rows, int cols,
                                    int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, data, rows, cols, box_rows);
}

// a row-major (rows, cols) f32 matrix, cols % 4 == 0: boxes of 32 floats
inline cudaError_t encode_f32_rows(CUtensorMap* map, const void* data, int rows, int cols,
                                   int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, data, rows, cols, box_rows);
}

// the streaming multiprocessors of the current device (1 if it cannot say):
// a persistent kernel's grid
inline int multiprocessors() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 1;
  return sms;
}

}  // namespace
}  // namespace dinov2
