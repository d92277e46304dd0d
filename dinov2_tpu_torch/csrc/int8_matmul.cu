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
//   - product: exact s32 sums on wgmma m64n256k32.s32.s8.s8;
//   - epilogue (Int8RescaleEpilogue<act, Out>): y = f32(acc) * sx[row] *
//     s[col], two rounded multiplies in that order; for bf16 out y rounds to
//     bf16, then + bf16(bias) rounded to bf16; for f32 out + bias in f32;
//     then the activation (activation.cuh) in f32 on that value, rounded to
//     the output type. No fused multiply-add anywhere in the chain. With
//     bf16 out, gelu_tanh_f16 is looked up in a table of the formula's own
//     results (gelu_tanh_f16_lookup), bit for bit the formula.
//
// What bounds it on an H100: at ViT-B/14 classify's fc1 (M = 16448, K = 768,
// N = 3072) the GEMM is 77.6 GOP over 12.6 MB of codes in, 2.4 MB of weight
// and 101 MB of bf16 out: operations, 0.039 ms at the 1979 TOPS int8 peak
// against 0.035 ms for the bytes. The quantize is all bytes: 25.3 MB in and
// 12.6 MB out at fc1's input, 0.011 ms; 101 + 51 MB at fc2's, 0.045 ms.
// Times on the card: PERF.md (K9's row), from chip_smoke.py and
// scripts/compare_kernel_builds.py.
//
// Design of the quantize: a warp holds its whole row in registers. Every
// lane issues all of its 16-byte loads (pieces lane, lane + 32, ...) before
// it reduces, so a row is read from device memory once with all its loads
// in flight; then the warp max, the scale, and the codes from the same
// registers. The pieces a lane holds are a template constant picked by the
// row's bytes (2, 6, 8, 12 or 16 KB: every published width in bf16 and
// f32), and the grid is as many blocks as the card holds at once, each warp
// walking rows warp, warp + all warps, ...
//
// Design of the GEMM: persistent and warp-specialised. One block an SM
// (min(tiles, SMs) blocks) walks the output tiles statically, tile
// blockIdx.x, then + gridDim.x, ..., N-fastest within a band of rows, so the
// blocks in flight share their A bands and the whole weight in L2. A block
// is three warpgroups:
//   - the producer: one thread keeps the TMA loads of each 128-deep k-step
//     (the A codes' rows and 256 weight rows, k-major 128-byte swizzled
//     boxes; rows past M or N land as zeros) in flight through a ring of
//     kInt8Stages stages, each with a "full" and an "empty" mbarrier
//     (tma_pipeline.cuh); the warpgroup gives its registers back
//     (setmaxnreg) to
//   - two consumers that share each 128 x 256 tile (cooperative), each with
//     128 s32 accumulators a thread for its 64 rows, four wgmma m64n256k32
//     a k-step on its A rows and the stage's shared weight rows, committed
//     and left running while the next step's stage is waited for; a stage
//     is given back (one arrival a warp of both) once the products after it
//     are waited for. The epilogue overlaps the producer's loads of the next
//     tile. A ping-pong build (a 64 x 256 tile a consumer, taken in turns,
//     one's epilogue under the other's products) was slower on an H100 at
//     fc1, fc2 and qkv (PERF.md): its lone epilogue warpgroup took longer
//     than the other's products, and its 64-row tiles read the weight stage
//     twice as often. It also needs its consumers ordered, since a parity
//     wait cannot tell a phase from the one two phases later: a consumer
//     that waits on a stage before the stage's previous fill has landed
//     passes at once.
// A consumer loads its tile's column scales and bias (and its rows'
// scales) before the tile's products, and stashes the columns in shared
// memory after them: the epilogue then reads no device memory but the
// table's copy. It writes a warp's 16 rows 64 bytes of columns at a time
// through a padded shared strip, then as whole 16-byte pieces of rows;
// columns past N are dropped (the head's N = 1000, N = 33 value by value),
// rows past M not written. K % 128 == 0: every published width has it (D in
// {384, 768, 1024, 1536}, 4D, the head's 2D, SwiGLU's 4096); the entry
// refuses any other K.

#include <chrono>

#include "activation.cuh"
#include "tma_pipeline.cuh"
#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kInt8Depth = 128;          // k of a step: one 128-byte swizzle row of codes
constexpr int kQuantizeThreads = 256;    // int8_quantize_rows_kernel: eight rows a block
constexpr float kScaleStep = 0x1.020408p-7f;    // f32(1 / 127), bits 0x3c010204
constexpr float kScaleFloor = 0x1.197998p-40f;  // f32(1e-12), bits 0x2b8cbccc

constexpr int kConsumers = 2;                          // consumer warpgroups, 64 rows each
constexpr int kInt8TileCols = 256;                     // wgmma m64n256k32
constexpr int kInt8TileRows = 64 * kConsumers;
constexpr int kInt8Stages = 4;                         // as many as shared memory holds
constexpr int kInt8AStageBytes = kInt8TileRows * kInt8Depth;
constexpr int kInt8StageBytes = kInt8AStageBytes + kInt8TileCols * kInt8Depth;
constexpr int kInt8Threads = 128 * (1 + kConsumers);   // the producer warpgroup first
constexpr int kEmptyArrivals = 4 * kConsumers;         // a warp each
constexpr int kProducerRegisters = 40, kConsumerRegisters = 232;
// a warp's strip: 16 rows of 64 bytes of output, 16 bytes of padding a row
// so that the accumulator layout's writes spread over the banks
constexpr int kInt8StripRowBytes = 64 + 16;
constexpr int kInt8StripBytes = 16 * kInt8StripRowBytes;
constexpr int kInt8StripsBytes = kConsumers * 4 * kInt8StripBytes;
// a consumer's stash of its tile's columns: {s, bias} of two columns a thread
constexpr int kInt8StashBytes = kConsumers * kInt8TileCols * 8;
constexpr int kInt8TableBytes = kGeluTableEntries * 2;
constexpr int kInt8SharedBytes = 1024 + kInt8Stages * kInt8StageBytes + kInt8StripsBytes +
                                 kInt8StashBytes + kInt8TableBytes + 2 * 8 * kInt8Stages;
static_assert(kInt8Depth == kRowBytes, "a k-step is one swizzle row");
static_assert(kInt8SharedBytes <= 232448, "the ring, strips, table and barriers fit");
static_assert(128 * kProducerRegisters + 128 * kConsumers * kConsumerRegisters <= 65536,
              "the registers the warpgroups hold after setmaxnreg exist");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the values of a 16-byte piece of T (8 bf16 or 4 f32) as f32
__device__ __forceinline__ void piece_values(const uint4& p, float (&v)[8]) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void piece_values(const uint4& p, float (&v)[4]) {
  v[0] = __uint_as_float(p.x);
  v[1] = __uint_as_float(p.y);
  v[2] = __uint_as_float(p.z);
  v[3] = __uint_as_float(p.w);
}

// lane's pieces l, l + 32, ... of row `row` of x (M, K), up to kPieces of
// them (zeros past the row), every load issued before any is used
template <typename T, int kPieces>
__device__ __forceinline__ void load_row(uint4 (&held)[kPieces], const T* __restrict__ x, int row,
                                         int k, int lane) {
  const int pieces = k / (16 / static_cast<int>(sizeof(T)));
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * k);
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = lane + 32 * p;
    held[p] = c < pieces ? src[c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// codes[row], scales[row] from the row's pieces held by the warp's lanes:
// the lane max, the warp max, the scale, then the codes
template <typename T, int kPieces>
__device__ __forceinline__ void quantize_row(const uint4 (&held)[kPieces],
                                             int8_t* __restrict__ codes,
                                             float* __restrict__ scales, int row, int k,
                                             int lane) {
  constexpr int kVec = 16 / sizeof(T);  // elements of a piece
  const int pieces = k / kVec;
  float ax = 0.f;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    float v[kVec];
    piece_values(held[p], v);
#pragma unroll
    for (int q = 0; q < kVec; ++q) ax = fmaxf(ax, fabsf(v[q]));
  }
  const float sx = __fmul_rn(fmaxf(warp_max(ax), kScaleFloor), kScaleStep);
  if (lane == 0) scales[row] = sx;
  int8_t* dst = codes + static_cast<size_t>(row) * k;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = lane + 32 * p;
    if (c < pieces) {
      float v[kVec];
      piece_values(held[p], v);
      uint32_t packed[kVec / 4];
#pragma unroll
      for (int w = 0; w < kVec / 4; ++w) {
        int code[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) code[q] = __float2int_rn(__fdiv_rn(v[4 * w + q], sx));
        // the low bytes of the four codes, in order
        packed[w] = __byte_perm(__byte_perm(code[0], code[1], 0x0040),
                                __byte_perm(code[2], code[3], 0x0040), 0x5410);
      }
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst + c * kVec) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst + c * kVec) = packed[0];
      }
    }
  }
}

// blocks an SM, for the registers a row leaves: as many as spill no more
// than fc2's 12 pieces a lane of bf16 do at 3 (56 bytes, the fastest there
// on an H100)
template <int kPieces>
constexpr int kQuantizeBlocksPerSm =
    kPieces <= 4 ? 5 : (kPieces <= 12 ? 3 : (kPieces <= 24 ? 2 : 1));

// codes[row], scales[row] for x (M, K) of T (bf16 or f32), one warp a row
// held whole in registers (load_row), the warps of the grid taking rows
// warp, warp + all warps, ... K % (16 / sizeof(T)) == 0 and K * sizeof(T)
// <= kPieces * 512.
template <typename T, int kPieces>
__global__ void __launch_bounds__(kQuantizeThreads, kQuantizeBlocksPerSm<kPieces>)
    int8_quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                              float* __restrict__ scales, int m, int k) {
  constexpr int kWarps = kQuantizeThreads / 32;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m; row += gridDim.x * kWarps) {
    uint4 held[kPieces];
    load_row<T, kPieces>(held, x, row, k, lane);
    quantize_row<T, kPieces>(held, codes, scales, row, k, lane);
  }
}

// the table of gelu_tanh_f16_lookup, made once a device by the wrapper
__global__ void int8_gelu_table_kernel(uint16_t* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kGeluTableEntries) table[i] = gelu_tanh_f16_entry(i);
}

// out[i] = gelu_tanh_f16_lookup(y[i]) for bf16 y: the epilogue's lookup
// alone, which chip_smoke.py holds against the plain gelu_tanh_f16 on every
// bf16 bit pattern
__global__ void int8_gelu_lookup_kernel(const uint16_t* __restrict__ y, uint16_t* __restrict__ out,
                                        int count, const uint16_t* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float g = gelu_tanh_f16_lookup(__uint_as_float(static_cast<uint32_t>(y[i]) << 16), table);
  out[i] = static_cast<uint16_t>(__float_as_uint(g) >> 16);
}

#define DINOV2_IACC8(d, b)                                                                     \
  "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])
#define DINOV2_IACC128(d)                                                                    \
  DINOV2_IACC8(d, 0), DINOV2_IACC8(d, 8), DINOV2_IACC8(d, 16), DINOV2_IACC8(d, 24),          \
      DINOV2_IACC8(d, 32), DINOV2_IACC8(d, 40), DINOV2_IACC8(d, 48), DINOV2_IACC8(d, 56),    \
      DINOV2_IACC8(d, 64), DINOV2_IACC8(d, 72), DINOV2_IACC8(d, 80), DINOV2_IACC8(d, 88),    \
      DINOV2_IACC8(d, 96), DINOV2_IACC8(d, 104), DINOV2_IACC8(d, 112), DINOV2_IACC8(d, 120)
#define DINOV2_IACC128_LIST                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "      \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "      \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "       \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x 256 of this warpgroup, s32) += A . B^T for one k32 step: A (64 x
// 32) and B (256 x 32) int8, both k-major in shared memory. d holds s32
// bits; element 4*nt + j is row 16*w + g + 8*(j >> 1), column 8*nt + 2*tig +
// (j & 1), nt = 0..31 (the f32 accumulator layout of wgmma_tiles.cuh).
__device__ __forceinline__ void wgmma_64x256x32_s8(uint32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " DINOV2_IACC128_LIST
      ", %128, %129, p;\n"
      "}\n"
      : DINOV2_IACC128(d)
      : "l"(a), "l"(b), "r"(1));
}

// a and b rounded to bf16 (to nearest, ties to even, as __float2bfloat16)
// in one paired conversion
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  a = __low2float(r);
  b = __high2float(r);
}

// out (M, N) of Out (bf16 or f32) = act(rescale(acc) + bias), the order of
// the note above; bias may be null. The activation is a template parameter
// (a runtime switch in K5's and K7's epilogue cost 14-20%, gemm_core.cuh).
template <int kAct, typename Out>
struct Int8RescaleEpilogue {
  using OutType = Out;
  static constexpr bool kBf16 = sizeof(Out) == 2;
  // the activation's input is a bf16 value: gelu_tanh_f16 by table
  static constexpr bool kTable = kBf16 && kAct == kGeluTanhF16;
  const float* sx;  // (M,) the rows' scales
  const float* s;   // (N,) the weight rows' scales
  const float* bias;
  Out* out;
  int m, n;

  __device__ __forceinline__ float round_out(float v) const {
    return kBf16 ? round_bf16(v) : v;
  }

  __device__ __forceinline__ float row_scale(int r) const { return r < m ? sx[r] : 0.f; }

  // {s, bias} of the columns c and c + 1, the bias in the output type; 0
  // past N. Without a bias it is -0: y + -0 is y for every y (+0 would turn
  // a -0 into +0), so the epilogue adds it with no branch. What a consumer
  // thread stashes for its tile.
  __device__ __forceinline__ float4 column_pair(int c) const {
    const float none = -0.f;
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < n) {
      sb.x = s[c];
      sb.y = bias ? round_out(bias[c]) : none;
    }
    if (c + 1 < n) {
      sb.z = s[c + 1];
      sb.w = bias ? round_out(bias[c + 1]) : none;
    }
    return sb;
  }

  // the two columns' values of one row before the activation: rescaled,
  // rounded to the output type, the bias added (the -0 of no bias leaves
  // them as they are) and rounded again; a bf16 pair rounds in one
  // conversion
  __device__ __forceinline__ float2 rescale(uint32_t a0, uint32_t a1, float sxr,
                                            const float4& sb) const {
    float y0 = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(a0)), sxr), sb.x);
    float y1 = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(a1)), sxr), sb.z);
    if constexpr (kBf16) round_bf16_pair(y0, y1);
    y0 = __fadd_rn(y0, sb.y);
    y1 = __fadd_rn(y1, sb.w);
    if constexpr (kBf16) round_bf16_pair(y0, y1);
    return make_float2(y0, y1);
  }

  // the activation by its formula (activation.cuh), for the epilogues
  // that do not look it up
  __device__ __forceinline__ float activation(float y) const { return activate(y, kAct); }

  // two finished values of adjacent columns into the strip at p, in the
  // output type
  __device__ __forceinline__ void put(uint8_t* p, float v0, float v1) const {
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

// This warp's 16 rows x 256 columns of a consumer's tile, from its
// accumulators: 64 bytes of columns at a time into its strip in the
// accumulator's layout, then out as 16-byte pieces of rows. The columns'
// scales and bias come from the consumer's stash (column_pair of two
// columns a float4), the rows' scales from sx_rows (rows g and g + 8). A
// chunk's values are all computed, and its activation applied to them
// together, before the strip is written: the stash's and the table's
// shared reads would otherwise wait behind the strip's writes, which the
// compiler cannot tell apart from them.
template <class Epilogue>
__device__ __forceinline__ void int8_store_tile(const Epilogue& ep, const uint32_t (&acc)[128],
                                                uint8_t* strip, const float4* stash,
                                                const uint16_t* table, const float (&sx_rows)[2],
                                                int row0, int col0, int lane) {
  constexpr int kOutBytes = static_cast<int>(sizeof(typename Epilogue::OutType));
  constexpr int kChunkCols = 64 / kOutBytes;   // 32 bf16 or 16 f32 columns a strip row
  constexpr int kChunkTiles = kChunkCols / 8;  // accumulator n-tiles of a chunk
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int chunk = 0; chunk < kInt8TileCols / kChunkCols; ++chunk) {
    const int chunk_col0 = col0 + chunk * kChunkCols;
    if (chunk_col0 < ep.n) {
      float v[kChunkTiles * 4];  // (t, h, column) of this lane
#pragma unroll
      for (int t = 0; t < kChunkTiles; ++t) {
        const int nt = chunk * kChunkTiles + t;
        const float4 sb = stash[(chunk * kChunkCols + t * 8 + 2 * tig) >> 1];  // {s, b} x 2
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 y = ep.rescale(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1], sx_rows[h], sb);
          v[4 * t + 2 * h] = y.x;
          v[4 * t + 2 * h + 1] = y.y;
        }
      }
      if constexpr (Epilogue::kTable) {
        gelu_tanh_f16_lookup_warp(v, table);
      } else {
#pragma unroll
        for (int i = 0; i < kChunkTiles * 4; ++i) v[i] = ep.activation(v[i]);
      }
#pragma unroll
      for (int t = 0; t < kChunkTiles; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ep.put(strip + (g + 8 * h) * kInt8StripRowBytes + (t * 8 + 2 * tig) * kOutBytes,
                 v[4 * t + 2 * h], v[4 * t + 2 * h + 1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // 16 rows x 4 pieces, 32 lanes
        const int piece = lane + 32 * q, r = piece >> 2, at = piece & 3;
        if (row0 + r < ep.m) {
          ep.store(row0 + r, chunk_col0 + at * (16 / kOutBytes),
                   *reinterpret_cast<const uint4*>(strip + r * kInt8StripRowBytes + at * 16));
        }
      }
      __syncwarp();
    }
  }
}

// The persistent GEMM: ep(a @ w^T) for a (M, K) and w (N, K) int8, both
// row-major, described by a_map (boxes of kInt8TileRows rows) and w_map
// (boxes of kInt8TileCols rows); see the note above. gelu_table is the
// global table of gelu_tanh_f16_lookup, used (copied to shared memory) by
// the epilogues that take it.
template <class Epilogue>
__global__ void __launch_bounds__(kInt8Threads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap w_map, Epilogue ep,
                     const uint16_t* __restrict__ gelu_table, int m, int n, int k) {
  extern __shared__ uint8_t shared_raw[];
  const uint32_t raw = shared_address(shared_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* strips = shared_raw + (ring - raw) + kInt8Stages * kInt8StageBytes;
  float4* stashes = reinterpret_cast<float4*>(strips + kInt8StripsBytes);
  uint16_t* table = reinterpret_cast<uint16_t*>(strips + kInt8StripsBytes + kInt8StashBytes);
  const uint32_t full0 = ring + kInt8Stages * kInt8StageBytes + kInt8StripsBytes +
                         kInt8StashBytes + kInt8TableBytes;
  const uint32_t empty0 = full0 + 8 * kInt8Stages;  // stage s: full0 + 8s, empty0 + 8s

  const int tiles_n = (n + kInt8TileCols - 1) / kInt8TileCols;
  const int tiles = (m + kInt8TileRows - 1) / kInt8TileRows * tiles_n;
  const int steps = k / kInt8Depth;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kInt8Stages; ++s) {
      mbarrier_init(full0 + 8 * s, 1);
      mbarrier_init(empty0 + 8 * s, kEmptyArrivals);
    }
    fence_barrier_init();
  }
  if constexpr (Epilogue::kTable) {
    for (int i = threadIdx.x; i < kInt8TableBytes / 16; i += kInt8Threads) {
      reinterpret_cast<uint4*>(table)[i] = reinterpret_cast<const uint4*>(gelu_table)[i];
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every load
    warpgroup_registers_down<kProducerRegisters>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&a_map);
      prefetch_tensor_map(&w_map);
      int pos = 0;  // the ring position of the next k-step: stage pos % S, round pos / S
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / tiles_n * kInt8TileRows, col0 = tile % tiles_n * kInt8TileCols;
        for (int j = 0; j < steps; ++j, ++pos) {
          const int stage = pos % kInt8Stages;
          mbarrier_wait(empty0 + 8 * stage, ((pos / kInt8Stages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * stage, a_s = ring + stage * kInt8StageBytes;
          mbarrier_arrive_expect_tx(full, kInt8StageBytes);
          tma_load_2d(a_s, &a_map, full, j * kInt8Depth, row0);
          tma_load_2d(a_s + kInt8AStageBytes, &w_map, full, j * kInt8Depth, col0);
        }
      }
    }
  } else {
    warpgroup_registers_up<kConsumerRegisters>();
    const int consumer = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, mine = threadIdx.x & 127;  // this thread within its consumer
    uint8_t* strip = strips + ((threadIdx.x >> 5) - 4) * kInt8StripBytes;
    float4* stash = stashes + consumer * (kInt8TileCols / 2);
    // every tile of the block, i-th in its walk; this consumer's 64 rows of it
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int row0 = tile / tiles_n * kInt8TileRows + consumer * kTile;
      const int col0 = tile % tiles_n * kInt8TileCols;
      // the tile's two columns of this thread and its two rows' scales, loaded
      // now: their latency passes under the products
      const float4 columns = ep.column_pair(col0 + 2 * mine);
      const float sx_rows[2] = {ep.row_scale(row0 + warp * 16 + g),
                                ep.row_scale(row0 + warp * 16 + g + 8)};
      uint32_t acc[128];
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] = 0u;
      int pos = i * steps;  // the producer loaded the block's tiles in order, `steps` each
      uint32_t held = 0;    // the empty barrier of the stage the last step read
      for (int j = 0; j < steps; ++j, ++pos) {
        const int stage = pos % kInt8Stages;
        mbarrier_wait(full0 + 8 * stage, (pos / kInt8Stages) & 1);
        const uint32_t a_s = ring + stage * kInt8StageBytes + consumer * kTileBytes;
        const uint64_t da = tile_descriptor(a_s);
        const uint64_t db = tile_descriptor(ring + stage * kInt8StageBytes + kInt8AStageBytes);
        fence_registers(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) wgmma_64x256x32_s8(acc, da + 2 * kc, db + 2 * kc);
        wgmma_commit();
        wgmma_wait<1>();  // the last step's products: its stage goes back
        if (j > 0) {
          __syncwarp();
          if (lane == 0) mbarrier_arrive(held);
        }
        held = empty0 + 8 * stage;
      }
      wgmma_wait<0>();
      fence_registers(acc);
      __syncwarp();
      if (lane == 0) mbarrier_arrive(held);
      named_barrier_sync(1 + consumer, 128);  // this consumer's last tile's stash is read
      stash[mine] = columns;
      named_barrier_sync(1 + consumer, 128);
      int8_store_tile(ep, acc, strip, stash, table, sx_rows, row0 + warp * 16, col0, lane);
    }
  }
}

inline int multiprocessors() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 1;
  return sms;
}

template <class Epilogue>
cudaError_t launch_int8_gemm(const CUtensorMap& a_map, const CUtensorMap& w_map, Epilogue ep,
                             const uint16_t* table, int m, int n, int k, cudaStream_t s) {
  auto kernel = int8_gemm_kernel<Epilogue>;
  static SharedMemoryGrant grant;
  cudaError_t err = grant(kernel, kInt8SharedBytes);
  if (err != cudaSuccess) return err;
  const int tiles =
      (m + kInt8TileRows - 1) / kInt8TileRows * ((n + kInt8TileCols - 1) / kInt8TileCols);
  const int sms = multiprocessors();
  kernel<<<tiles < sms ? tiles : sms, kInt8Threads, kInt8SharedBytes, s>>>(a_map, w_map, ep, table, m, n, k);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t int8_gemm_for(const CUtensorMap& a_map, const CUtensorMap& w_map, const float* sx,
                          const float* s, const float* bias, int activation, void* out,
                          const uint16_t* table, int m, int n, int k, cudaStream_t stream) {
  Out* out_ = static_cast<Out*>(out);
  auto gemm = [&](auto ep) { return launch_int8_gemm(a_map, w_map, ep, table, m, n, k, stream); };
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

// every row by a grid of as many blocks as the card holds at once (or
// fewer, when there are fewer rows), each warp walking its rows
template <typename T, int kPieces>
cudaError_t launch_quantize(const T* x, int8_t* codes, float* scales, int m, int k,
                            cudaStream_t s) {
  auto kernel = int8_quantize_rows_kernel<T, kPieces>;
  static const int per_sm = [&] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kQuantizeThreads, 0);
    return blocks > 0 ? blocks : 1;
  }();
  constexpr int kRowsPerBlock = kQuantizeThreads / 32;
  const int needed = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  const int resident = per_sm * multiprocessors();
  kernel<<<needed < resident ? needed : resident, kQuantizeThreads, 0, s>>>(x, codes, scales, m, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize_for(const void* x, int8_t* codes, float* scales, int m, int k,
                         cudaStream_t s) {
  const T* x_ = static_cast<const T*>(x);
  const long long row_bytes = static_cast<long long>(k) * sizeof(T);
  if (row_bytes <= 4 * 512) return launch_quantize<T, 4>(x_, codes, scales, m, k, s);
  if (row_bytes <= 12 * 512) return launch_quantize<T, 12>(x_, codes, scales, m, k, s);
  if (row_bytes <= 16 * 512) return launch_quantize<T, 16>(x_, codes, scales, m, k, s);
  if (row_bytes <= 24 * 512) return launch_quantize<T, 24>(x_, codes, scales, m, k, s);
  if (row_bytes <= 32 * 512) return launch_quantize<T, 32>(x_, codes, scales, m, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dinov2

extern "C" {

// codes (M, K) int8 and scales (M,) f32 = quantize_rows(x) on `stream`, x
// (M, K) bf16 (x_f32 == 0) or f32. Requires K % 16 == 0, a row of at most
// 16 KB and 16-byte aligned pointers (cudaErrorInvalidValue before any
// launch otherwise).
int dinov2_int8_quantize_rows(const void* x, int x_f32, void* codes, void* scales, int m, int k,
                              void* stream) {
  using namespace dinov2;
  if (k % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* codes_ = static_cast<int8_t*>(codes);
  float* scales_ = static_cast<float*>(scales);
  if (x_f32) return quantize_for<float>(x, codes_, scales_, m, k, s);
  return quantize_for<bf16>(x, codes_, scales_, m, k, s);
}

// y (M, N) = act(f32(x8 @ W^T) * sx * s + bias) on `stream`: x8 (M, K) int8
// with its row scales sx (M,) f32, W (N, K) int8 with s (N,) f32, bias (N,)
// f32 or null, y bf16 (out_f32 == 0) or f32. activation is 0 none,
// 1 gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh. gelu_table is the table
// dinov2_int8_gelu_table made on this device, needed by gelu_tanh_f16 with
// bf16 out (null otherwise is fine). Requires M, N >= 1, K % 128 == 0 and
// 16-byte aligned pointers; another activation or K, or a missing table,
// returns cudaErrorInvalidValue before any launch.
int dinov2_int8_gemm(const void* x8, const void* sx, const void* codes, const void* s,
                     const void* bias, int activation, void* out, int out_f32, int m, int n,
                     int k, void* stream, const void* gelu_table) {
  using namespace dinov2;
  if (activation < kNone || activation > kGeluTanh || k % kInt8Depth || m < 1 || n < 1) {
    return cudaErrorInvalidValue;
  }
  if (activation == kGeluTanhF16 && !out_f32 && gelu_table == nullptr) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap a_map, w_map;
  cudaError_t err = encode_int8_rows(&a_map, x8, m, k, kInt8TileRows);
  if (err == cudaSuccess) err = encode_int8_rows(&w_map, codes, n, k, kInt8TileCols);
  if (err != cudaSuccess) return err;
  const auto* sx_ = static_cast<const float*>(sx);
  const auto* s_ = static_cast<const float*>(s);
  const auto* bias_ = static_cast<const float*>(bias);
  const auto* table = static_cast<const uint16_t*>(gelu_table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    return int8_gemm_for<float>(a_map, w_map, sx_, s_, bias_, activation, out, table, m, n, k, st);
  }
  return int8_gemm_for<bf16>(a_map, w_map, sx_, s_, bias_, activation, out, table, m, n, k, st);
}

// table (kGeluTableEntries,) u16 = the bf16 gelu_tanh_f16 of each bf16
// input the GEMM's table covers, on `stream`
int dinov2_int8_gelu_table(void* table, void* stream) {
  using namespace dinov2;
  int8_gelu_table_kernel<<<(kGeluTableEntries + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(static_cast<uint16_t*>(table));
  return cudaGetLastError();
}

// out (count,) bf16 = the GEMM epilogue's table lookup of y (count,) bf16
int dinov2_int8_gelu_lookup(const void* y, void* out, int count, const void* table,
                            void* stream) {
  using namespace dinov2;
  if (count < 1) return cudaErrorInvalidValue;
  int8_gelu_lookup_kernel<<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(y), static_cast<uint16_t*>(out), count,
      static_cast<const uint16_t*>(table));
  return cudaGetLastError();
}

// the GEMM's build: {consumers sharing a tile, tile rows, tile columns,
// ring stages, dynamic shared bytes, producer and consumer registers a
// thread after setmaxnreg}
void dinov2_int8_gemm_variant(int* out) {
  using namespace dinov2;
  const int v[7] = {kConsumers, kInt8TileRows, kInt8TileCols, kInt8Stages,
                    kInt8SharedBytes, kProducerRegisters, kConsumerRegisters};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// host microseconds to encode the tensor map of a (rows, cols) int8 matrix
// at `data` as the GEMM does x8's, averaged over `reps`; negative if the
// encode fails
double dinov2_int8_tensor_map_us(const void* data, int rows, int cols, int reps) {
  using namespace dinov2;
  CUtensorMap map;
  if (encode_int8_rows(&map, data, rows, cols, kInt8TileRows) != cudaSuccess) return -1.0;
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) encode_int8_rows(&map, data, rows, cols, kInt8TileRows);
  const std::chrono::duration<double, std::micro> spent = std::chrono::steady_clock::now() - start;
  return spent.count() / (reps > 0 ? reps : 1);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
