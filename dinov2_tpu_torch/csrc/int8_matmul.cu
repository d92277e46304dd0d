// K9 on Hopper: the W8A8 int8 matmul of quant_mode="int8",
//
//     x8 (M, K) int8, sx (M,) f32 = quantize_rows(x)     int8_quantize_rows_kernel
//     y (M, N) = act(rescale(x8 @ W^T) + bias)           int8_gemm_kernel
//
// for x (M, K) bf16 or f32 and an (N, K) Int8Linear W (models/params.py:
// int8 codes, an f32 scale a row). It replaces dinov2_tpu/ops/qmatmul.py::
// int8_matmul, which is no Pallas kernel: the JAX package leaves the
// s8 x s8 -> s32 dot_general to XLA, which fuses the quantize into the
// elementwise chain in front of it and the rescale, bias and activation into
// its epilogue. torch._int_mm would write the (M, N) s32 product to device
// memory and leave the rescale and the epilogue to separate passes (202 MB
// each way at ViT-B/14's fc1, M = 64 * 257), so the port writes the GEMM
// with its epilogue fused.
//
// Numerics, the JAX package's order, bit for bit (ops/qmatmul.py::
// int8_matmul_reference on an exact s32 product):
//   - quantize, a warp a row: the row's absmax in f32 (finite inputs; a NaN
//     is not carried), sx = max(absmax, f32(1e-12)) * f32(1/127) with JAX's
//     constants written out as hex floats, codes = round-half-even(x / sx)
//     with an IEEE division (__fdiv_rn: no fast-math flag in _kernels.py).
//     |x / sx| <= 127 by construction, so there is no clip;
//   - product: exact s32 sums on wgmma m64n128k32.s32.s8.s8;
//   - epilogue (Int8RescaleEpilogue<act, Out>): y = f32(acc) * sx[row] *
//     s[col], two rounded multiplies in that order; for bf16 out y rounds to
//     bf16, then + bf16(bias) rounded to bf16; for f32 out + bias in f32;
//     then the activation (activation.cuh) in f32 on that value, rounded to
//     the output type. No fused multiply-add anywhere in the chain.
//
// What bounds it on an H100: at ViT-B/14 classify's fc1 (M = 16448, K = 768,
// N = 3072) the GEMM is 77.6 GOP over 12.6 MB of codes in, 2.4 MB of weight
// and 101 MB of bf16 out: operations, 0.039 ms at the 1979 TOPS int8 peak
// against 0.035 ms for the bytes. The quantize is all bytes: 25.3 MB in and
// 12.6 MB out at fc1's input, 0.011 ms. Measured on an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py, PERF.md): the GEMM 0.18-0.19 ms at fc1, of which
// the GELU epilogue is ~0.1, and 0.081 ms at fc2 (961 TOPS); the quantize
// 0.018 ms at fc1's input and 0.083 ms at fc2's (54% of its bound: a row is
// read twice).
//
// Design. The GEMM is the bf16 core of wgmma_gemm.cuh on its k-major weight
// path, with 8-bit operands: wgmma takes an 8-bit operand k-major only, and
// both are (x8's rows, and the codes in their (out, in) layout: no transposed
// copy exists anywhere). A block owns a 128 x kGemmCols output tile, four
// warpgroups of 64 rows x 128 columns. A 128-byte swizzled row holds 128
// codes, so a k-step is 128 deep, four k32 products a warpgroup, and a
// stage holds the same bytes as the bf16 core's (the A tile, then kGemmCols
// k-major weight rows, rows past M or N zero-filled), in a kGemmStages ring
// filled by cp.async two steps ahead. A step's products are committed and
// left running while the next step lands; no branch goes around a wgmma and
// nothing else touches the accumulators in the loop, so ptxas keeps them
// asynchronous. The s32 accumulators have the f32 layout (wgmma_tiles.cuh).
// The epilogue rescales a warp's 16 x 128 piece into a padded strip of the
// ring and writes whole 16-byte pieces of rows; columns past N are dropped
// (the head's N = 1000), rows past M not written. K % 128 == 0: every
// published width has it (D in {384, 768, 1024, 1536}, 4D, the head's 2D,
// SwiGLU's 4096); the entry refuses any other K.

#include "activation.cuh"
#include "wgmma_gemm.cuh"

namespace dinov2 {
namespace {

constexpr int kInt8Depth = 128;          // k of a step: one 128-byte swizzle row of codes
constexpr int kQuantizeThreads = 256;    // int8_quantize_rows_kernel: eight rows a block
constexpr float kScaleStep = 0x1.020408p-7f;    // f32(1 / 127), bits 0x3c010204
constexpr float kScaleFloor = 0x1.197998p-40f;  // f32(1e-12), bits 0x2b8cbccc
static_assert(kInt8Depth == kRowBytes, "a k-step is one swizzle row");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// codes[row], scales[row] for x (M, K) of T (bf16 or f32), one warp a row:
// the absmax over 16-byte pieces, a warp max, then the same pieces again
// (from L1/L2) divided and rounded. K % 16 == 0.
template <typename T>
__global__ void __launch_bounds__(kQuantizeThreads)
    int8_quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                              float* __restrict__ scales, int m, int k) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte piece
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kQuantizeThreads / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* src = x + static_cast<size_t>(row) * k;
  float ax = 0.f;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    const uint4 piece = *reinterpret_cast<const uint4*>(src + c);
    const T* e = reinterpret_cast<const T*>(&piece);
#pragma unroll
    for (int q = 0; q < kVec; ++q) ax = fmaxf(ax, fabsf(to_float(e[q])));
  }
  const float sx = __fmul_rn(fmaxf(warp_max(ax), kScaleFloor), kScaleStep);
  if (lane == 0) scales[row] = sx;
  int8_t* dst = codes + static_cast<size_t>(row) * k;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    const uint4 piece = *reinterpret_cast<const uint4*>(src + c);
    const T* e = reinterpret_cast<const T*>(&piece);
    alignas(8) int8_t q8[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      q8[q] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(to_float(e[q]), sx)));
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(dst + c) = *reinterpret_cast<const uint2*>(q8);
    } else {
      *reinterpret_cast<uint32_t*>(dst + c) = *reinterpret_cast<const uint32_t*>(q8);
    }
  }
}

// Rows r0..r0+kRows-1 of an (rows, ld) int8 matrix, 128 bytes from src on,
// into the swizzled tile at shared address dst by all kThreadsN threads;
// rows past t zero-filled. load_tile_async's walk in bytes.
template <int kRows, int kThreadsN>
__device__ __forceinline__ void load_codes_async(uint32_t dst, const int8_t* __restrict__ src,
                                                 size_t ld, int r0, int t) {
  static_assert(kRows * 8 % kThreadsN == 0 && kThreadsN % 64 == 0, "whole steps of whole groups");
  constexpr int kSteps = kRows * 8 / kThreadsN, kRowStep = kThreadsN / 8;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const uint32_t dst_t = dst + swizzled(r, c);
  const int8_t* src_t = src + static_cast<size_t>(r0 + r) * ld + c * 16;
  const size_t step = static_cast<size_t>(kRowStep) * ld;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const bool valid = r0 + r + s * kRowStep < t;
    cp_async_16(dst_t + s * kRowStep * kRowBytes, valid ? src_t + s * step : src, valid);
  }
}

#define DINOV2_IACC64(d)                                                                      \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),         \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),           \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),           \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),           \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),           \
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),           \
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),           \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),           \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),           \
      "+r"(d[62]), "+r"(d[63])

// d (64 x 128 of this warpgroup, s32) += A . B^T for one k32 step: A (64 x
// 32) and B (128 x 32) int8, both k-major in shared memory. d holds s32
// bits; element 4*nt + j is row 16*w + g + 8*(j >> 1), column 8*nt + 2*tig +
// (j & 1), as the f32 accumulators of wgmma_gemm.cuh.
__device__ __forceinline__ void wgmma_64x128x32_s8(uint32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DINOV2_ACC64_LIST
      ", %64, %65, p;\n"
      "}\n"
      : DINOV2_IACC64(d)
      : "l"(a), "l"(b), "r"(1));
}

// What the s32 sums of the columns c and c + 1 share across rows: their
// scales and their bias in the output type (0 past N or without a bias).
struct Int8Column {
  float s0, s1, b0, b1;
};

// out (M, N) of Out (bf16 or f32) = act(rescale(acc) + bias), the order of
// the note above; bias may be null. The activation is a template parameter
// (a runtime switch in K5's and K7's epilogue cost 14-20%, gemm_core.cuh).
template <int kAct, typename Out>
struct Int8RescaleEpilogue {
  using OutType = Out;
  static constexpr bool kBf16 = sizeof(Out) == 2;
  // a row of a warp's strip: 128 values plus 16 bytes, so that the
  // accumulator layout's writes spread over the banks
  static constexpr int kStripRowBytes = 128 * static_cast<int>(sizeof(Out)) + 16;
  const float* sx;  // (M,) the rows' scales
  const float* s;   // (N,) the weight rows' scales
  const float* bias;
  Out* out;
  int m, n;

  __device__ __forceinline__ float round_out(float v) const {
    return kBf16 ? round_bf16(v) : v;
  }

  __device__ __forceinline__ float row_scale(int r) const { return r < m ? sx[r] : 0.f; }

  __device__ __forceinline__ Int8Column column(int c) const {
    Int8Column col{0.f, 0.f, 0.f, 0.f};
    if (c < n) {
      col.s0 = s[c];
      if (bias) col.b0 = round_out(bias[c]);
    }
    if (c + 1 < n) {
      col.s1 = s[c + 1];
      if (bias) col.b1 = round_out(bias[c + 1]);
    }
    return col;
  }

  __device__ __forceinline__ float value(uint32_t acc, float sxr, float sc, float b) const {
    float y = round_out(__fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc)), sxr), sc));
    if (bias) y = round_out(__fadd_rn(y, b));
    return activate(y, kAct);
  }

  // the columns c, c + 1 of one row into the strip at p, in the output type
  __device__ __forceinline__ void put(uint8_t* p, float sxr, const Int8Column& col, uint32_t a0,
                                      uint32_t a1) const {
    const float v0 = value(a0, sxr, col.s0, col.b0), v1 = value(a1, sxr, col.s1, col.b1);
    if constexpr (kBf16) {
      *reinterpret_cast<uint32_t*>(p) = pack_floats(v0, v1);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    }
  }

  // 16 bytes of finished values at row `row`, columns c.. (c a multiple of
  // the piece's width); a row of a width that leaves it unaligned is
  // written value by value
  __device__ __forceinline__ void store(int row, int c, uint4 v) const {
    constexpr int kVec = 16 / sizeof(Out);
    Out* dst = out + static_cast<size_t>(row) * n + c;
    if (n % kVec == 0) {
      if (c < n) *reinterpret_cast<uint4*>(dst) = v;
      return;
    }
    const Out* e = reinterpret_cast<const Out*>(&v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (c + i < n) dst[i] = e[i];
    }
  }
};

// One block's 128 x kGemmCols output tile of ep(a @ w^T) for a (M, K) and w
// (N, K) int8, both row-major; see the note above.
template <class Epilogue>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w, Epilogue ep,
                     int m, int n, int k) {
  constexpr int kStripRow = Epilogue::kStripRowBytes;
  static_assert(kGemmThreads / 32 * 16 * kStripRow <= kGemmStages * kGemmStageBytes,
                "the strips fit in the ring");
  extern __shared__ uint8_t shared_raw[];
  const uint32_t ring = (shared_address(shared_raw) + 1023u) & ~1023u;
  uint8_t* ring_ptr = shared_raw + (ring - shared_address(shared_raw));

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int wg_row = wg & 1, wg_col = wg >> 1;  // this warpgroup's 64 rows, 128 columns
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kGemmRows, col0 = blockIdx.x * kGemmCols;
  const int steps = k / kInt8Depth;

  // step j's A rows and W rows, those past M or N zero-filled
  auto load_step = [&](int stage, int j) {
    const uint32_t a_s = ring + stage * kGemmStageBytes, w_s = a_s + kGemmRows * kRowBytes;
    const size_t at = static_cast<size_t>(j) * kInt8Depth;
    load_codes_async<kGemmRows, kGemmThreads>(a_s, a + at, static_cast<size_t>(k), row0, m);
    load_codes_async<kGemmCols, kGemmThreads>(w_s, w + at, static_cast<size_t>(k), col0, n);
  };

  // groups are committed even when empty, so that step j is always group j
#pragma unroll
  for (int s = 0; s < kGemmStages - 2; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }

  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0u;

  int stage = 0, fill = kGemmStages - 2;  // the stage of step j, of step j + kGemmStages - 2
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kGemmStages - 3>();  // this thread's part of step j has landed
    const uint32_t a_s = ring + stage * kGemmStageBytes;
    fence_proxy_async();
    // everyone's part of step j has landed, and every warpgroup has waited
    // for its products of step j - 2, whose stage is the one to fill
    __syncthreads();
    if (j + kGemmStages - 2 < steps) load_step(fill, j + kGemmStages - 2);
    cp_async_commit();

    // this warpgroup's 64 A rows (8 KB) and 128 weight rows (16 KB); a k32
    // step is 32 bytes on inside the swizzle rows of both
    const uint32_t w_s = a_s + kGemmRows * kRowBytes + wg_col * 128 * kRowBytes;
    const uint64_t da = tile_descriptor(a_s + wg_row * kTileBytes);
    const uint64_t db = tile_descriptor(w_s);
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_64x128x32_s8(acc, da + 2 * kc, db + 2 * kc);
    wgmma_commit();
    wgmma_wait<1>();  // step j - 1's products
    stage = stage + 1 == kGemmStages ? 0 : stage + 1;
    fill = fill + 1 == kGemmStages ? 0 : fill + 1;
  }
  wgmma_wait<0>();
  fence_registers(acc);
  __syncthreads();  // every warpgroup is done with the ring: the strips go there

  // this warp's 16 rows x 128 columns, rescaled into its strip in the
  // accumulator's layout, then written out 16 bytes a lane
  uint8_t* strip = ring_ptr + (threadIdx.x >> 5) * 16 * kStripRow;
  const int wg_col0 = col0 + wg_col * 128;
  const int strip_row0 = row0 + wg_row * kTile + warp * 16;
  const float sx_rows[2] = {ep.row_scale(strip_row0 + g), ep.row_scale(strip_row0 + g + 8)};
  constexpr int kOutBytes = static_cast<int>(sizeof(typename Epilogue::OutType));
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = nt * 8 + 2 * tig;
    const Int8Column col = ep.column(wg_col0 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ep.put(strip + (g + 8 * h) * kStripRow + c * kOutBytes, sx_rows[h], col,
             acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
  __syncwarp();
  constexpr int kPieces = 128 * kOutBytes / 16;  // 16-byte pieces of a strip row
#pragma unroll
  for (int i = lane; i < 16 * kPieces; i += 32) {
    const int r = i / kPieces, piece = i % kPieces;
    if (strip_row0 + r < m) {
      ep.store(strip_row0 + r, wg_col0 + piece * (16 / kOutBytes),
               *reinterpret_cast<const uint4*>(strip + r * kStripRow + piece * 16));
    }
  }
}

template <class Epilogue>
cudaError_t launch_int8_gemm(const int8_t* a, const int8_t* w, Epilogue ep, int m, int n, int k,
                             cudaStream_t s) {
  auto kernel = int8_gemm_kernel<Epilogue>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kGemmSharedBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kGemmCols - 1) / kGemmCols, (m + kGemmRows - 1) / kGemmRows), kGemmThreads,
           kGemmSharedBytes, s>>>(a, w, ep, m, n, k);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t int8_gemm_for(const int8_t* a, const float* sx, const int8_t* w, const float* s,
                          const float* bias, int activation, void* out, int m, int n, int k,
                          cudaStream_t stream) {
  Out* out_ = static_cast<Out*>(out);
  auto gemm = [&](auto ep) { return launch_int8_gemm(a, w, ep, m, n, k, stream); };
  switch (activation) {
    case kGeluTanhF16:
      return gemm(Int8RescaleEpilogue<kGeluTanhF16, Out>{sx, s, bias, out_, m, n});
    case kGeluErf:
      return gemm(Int8RescaleEpilogue<kGeluErf, Out>{sx, s, bias, out_, m, n});
    case kGeluTanh:
      return gemm(Int8RescaleEpilogue<kGeluTanh, Out>{sx, s, bias, out_, m, n});
    default:
      return gemm(Int8RescaleEpilogue<kNone, Out>{sx, s, bias, out_, m, n});
  }
}

}  // namespace
}  // namespace dinov2

extern "C" {

// codes (M, K) int8 and scales (M,) f32 = quantize_rows(x) on `stream`, x
// (M, K) bf16 (x_f32 == 0) or f32. Requires K % 16 == 0 and 16-byte aligned
// pointers (cudaErrorInvalidValue before any launch otherwise).
int dinov2_int8_quantize_rows(const void* x, int x_f32, void* codes, void* scales, int m, int k,
                              void* stream) {
  using namespace dinov2;
  if (k % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kRowsPerBlock = kQuantizeThreads / 32;
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  int8_t* codes_ = static_cast<int8_t*>(codes);
  float* scales_ = static_cast<float*>(scales);
  if (x_f32) {
    int8_quantize_rows_kernel<float><<<blocks, kQuantizeThreads, 0, s>>>(
        static_cast<const float*>(x), codes_, scales_, m, k);
  } else {
    int8_quantize_rows_kernel<bf16><<<blocks, kQuantizeThreads, 0, s>>>(
        static_cast<const bf16*>(x), codes_, scales_, m, k);
  }
  return cudaGetLastError();
}

// y (M, N) = act(f32(x8 @ W^T) * sx * s + bias) on `stream`: x8 (M, K) int8
// with its row scales sx (M,) f32, W (N, K) int8 with s (N,) f32, bias (N,)
// f32 or null, y bf16 (out_f32 == 0) or f32. activation is 0 none,
// 1 gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh. Requires K % 128 == 0 and
// 16-byte aligned pointers; another activation or K returns
// cudaErrorInvalidValue before any launch.
int dinov2_int8_gemm(const void* x8, const void* sx, const void* codes, const void* s,
                     const void* bias, int activation, void* out, int out_f32, int m, int n,
                     int k, void* stream) {
  using namespace dinov2;
  if (activation < kNone || activation > kGeluTanh || k % kInt8Depth) {
    return cudaErrorInvalidValue;
  }
  const auto* a = static_cast<const int8_t*>(x8);
  const auto* w = static_cast<const int8_t*>(codes);
  const auto* sx_ = static_cast<const float*>(sx);
  const auto* s_ = static_cast<const float*>(s);
  const auto* bias_ = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) return int8_gemm_for<float>(a, sx_, w, s_, bias_, activation, out, m, n, k, st);
  return int8_gemm_for<bf16>(a, sx_, w, s_, bias_, activation, out, m, n, k, st);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
