// The port's one f32 GEMM: persistent, warp-specialised 3xTF32 on Hopper's
// tensor cores (tf32x3.cuh), for every f32 kernel that multiplies by a
// weight: K1 f32 and K8 f32 (half_layer.cuh's QKV and proj), K2 f32's proj
// (slab_attention.cu), K5 f32's fc1 and fc2 (slab_mlp.cu) and K7 f32
// (quant_matmul.cu),
//
//     out (M, N) = ep(x (M, K) @ W^T)
//
// for f32 x row-major and W given as its two TF32 planes (2, N, K), hi =
// tf32(w) and lo = tf32(w - hi), K-major, the only layout wgmma takes for
// .tf32. A QuantLinear is (N, K) already, so K7 and K8 dequantize straight
// into the planes (dequant_tile.cuh's Tf32SplitRows); a dense weight is
// stored (in, out), (K, N), and split_tf32_t_kernel below splits and
// transposes it into them once a call, into a scratch the caller
// allocated.
//
// Design: one block an SM walks 128 x 128 output tiles, N-fastest. A
// producer warpgroup's one thread keeps TMA loads (tma_pipeline.cuh) of
// each 32-deep k-step in flight through a 4-stage mbarrier ring: x's 128
// rows (row-major, so K-major as wgmma wants A) and the 128 weight rows of
// each plane, all 128-byte swizzled, rows past M or N and columns past K
// landing as zeros (so K % 32 != 0 is a last k-step filled with zeros that
// add nothing). Two consumer warpgroups own 64 rows each: a consumer splits
// its x rows once they land, hi in place and lo into a buffer of its own
// (two, taken in turn), then runs the step's 12 wgmma m64n128k8 (three
// products of four k8 steps) into a fresh chunk accumulator, waits for them
// and adds the chunk to its f32 sum with rounded adds (tf32x3.cuh's note:
// the tensor cores truncate as they sum). The epilogue writes a thread's
// column pairs straight from the accumulator layout, masked at M and N,
// while the producer already loads the next tile.
//
// Epilogues, in the JAX package's f32 order (every cast to the compute
// dtype a no-op), each step rounded once (__fadd_rn, __fmul_rn: nvcc cannot
// contract them into a fused multiply-add):
//   F32Bias      acc + b                        K1's QKV
//   F32Residual  x + (acc + b) * ls              K1's and K2's proj, K5's fc2
//   F32Act<act>  act(acc [+ b]), b optional      K5's fc1, K7
// gelu_tanh_f16 (activation.cuh) goes through f16 on both sides.
//
// What bounds it on an H100: 3xTF32 runs three TF32 passes at 494.7
// TFLOP/s, 165 TFLOP/s of f32-accurate products. At K5's fc1 (M = 16448, K
// = 768, N = 3072) a call is 77.6 GFLOP, 0.47 ms at that rate, against
// 0.09 ms for 50.5 MB of x, 202 MB of out and 18.9 MB of planes: the
// products bind it. Each k-step a block reads 48 KB of shared memory
// through the TMA for 3 x 2 x 128 x 128 x 32 operations.

#pragma once

#include "activation.cuh"
#include "tf32x3.cuh"
#include "tma_pipeline.cuh"

namespace dinov2 {
namespace {

constexpr int kTf32x3Depth = kTf32AtomFloats;  // k of a step: one 128-byte swizzle row of f32
constexpr int kTf32x3Consumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kTf32x3TileRows = 64 * kTf32x3Consumers;
constexpr int kTf32x3TileCols = 128;           // wgmma m64n128k8
constexpr int kTf32x3Stages = 4;
constexpr int kTf32x3XBytes = kTf32x3TileRows * 128;  // x's rows of a step, raw, then its hi plane
constexpr int kTf32x3WBytes = kTf32x3TileCols * 128;  // one plane of the weight's rows of a step
constexpr int kTf32x3StageBytes = kTf32x3XBytes + 2 * kTf32x3WBytes;
// x's lo plane: a consumer's 64 rows, two buffers taken in turn by the steps
constexpr int kTf32x3LoBytes = 2 * kTf32x3Consumers * kTileBytes;
constexpr int kTf32x3Threads = 128 * (1 + kTf32x3Consumers);  // the producer warpgroup first
constexpr int kTf32x3EmptyArrivals = 4 * kTf32x3Consumers;    // a warp each
constexpr int kTf32x3ProducerRegisters = 40, kTf32x3ConsumerRegisters = 232;
constexpr int kTf32x3SharedBytes =
    1024 + kTf32x3Stages * kTf32x3StageBytes + kTf32x3LoBytes + 2 * 8 * kTf32x3Stages;
static_assert(kTf32x3SharedBytes <= 232448, "the ring, x's lo planes and the barriers fit");
static_assert(128 * kTf32x3ProducerRegisters +
                      128 * kTf32x3Consumers * kTf32x3ConsumerRegisters <=
                  65536,
              "the registers the warpgroups hold after setmaxnreg exist");

// y0, y1 to out[row, c] and out[row, c + 1], the second only where `pair`
// (c + 1 < n): one 8-byte store where N is even (c is)
__device__ __forceinline__ void store_pair(float* out, int n, int row, int c, float y0, float y1,
                                           bool pair) {
  float* dst = out + static_cast<size_t>(row) * n + c;
  if (pair && n % 2 == 0) {
    *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
  } else {
    dst[0] = y0;
    if (pair) dst[1] = y1;
  }
}

// An epilogue reads what a thread's two columns c, c + 1 need once
// (columns; nothing past N), then turns each row's two sums into the two
// values stored (apply), with no branch around the arithmetic.

// out (M, N) = acc + bias
struct F32Bias {
  const float* bias;
  float* out;
  int n;

  __device__ __forceinline__ float2 columns(int c, bool pair) const {
    return make_float2(__ldg(bias + c), pair ? __ldg(bias + c + 1) : 0.f);
  }
  __device__ __forceinline__ float2 apply(float2 b, int, int, bool, float a0, float a1) const {
    return make_float2(__fadd_rn(a0, b.x), __fadd_rn(a1, b.y));
  }
};

// out = resid + (acc + bias) * ls, in that order, each step rounded once
// (no fused multiply-add: the plain version's three operations)
struct F32Residual {
  const float* bias;
  const float* ls;
  const float* resid;
  float* out;
  int n;

  __device__ __forceinline__ float4 columns(int c, bool pair) const {
    return make_float4(__ldg(bias + c), pair ? __ldg(bias + c + 1) : 0.f, __ldg(ls + c),
                       pair ? __ldg(ls + c + 1) : 0.f);
  }
  __device__ __forceinline__ float2 apply(float4 bl, int row, int c, bool pair, float a0,
                                          float a1) const {
    const float* x = resid + static_cast<size_t>(row) * n + c;
    const float x0 = x[0], x1 = pair ? x[1] : 0.f;
    return make_float2(__fadd_rn(x0, __fmul_rn(__fadd_rn(a0, bl.x), bl.z)),
                       __fadd_rn(x1, __fmul_rn(__fadd_rn(a1, bl.y), bl.w)));
  }
};

// out (M, N) = act(acc + bias), or act(acc) where bias is null (K7 without
// a bias): K5's fc1 in the JAX order (a1 + b1, then apply_activation,
// fused_attention.py:876-877), the bias add rounded once before the
// activation; activation.cuh's formulas, gelu_tanh_f16 through f16 on both
// sides (round to nearest even, +-inf past 65504, no clamp)
template <int kAct>
struct F32Act {
  const float* bias;
  float* out;
  int n;

  __device__ __forceinline__ float2 columns(int c, bool pair) const {
    return make_float2(bias ? __ldg(bias + c) : 0.f, bias && pair ? __ldg(bias + c + 1) : 0.f);
  }
  __device__ __forceinline__ float2 apply(float2 b, int, int, bool, float a0, float a1) const {
    if (bias) a0 = __fadd_rn(a0, b.x), a1 = __fadd_rn(a1, b.y);
    return make_float2(activate(a0, kAct), activate(a1, kAct));
  }
};

// The tensor maps of one GEMM: x (M, K) in boxes of kTf32x3TileRows rows,
// the weight's hi and lo planes (N, K) each in boxes of kTf32x3TileCols
// rows. Encoded on the host before the launches that fill them, so the card
// does not wait on the encode between a weight's split and its GEMM.
struct Tf32x3Maps {
  CUtensorMap x, hi, lo;
};

// maps for x (M, K) and planes (2, N, K); K % 4 == 0 (a row of a multiple
// of 16 bytes), x and planes 16-byte aligned
inline cudaError_t encode_tf32x3_maps(Tf32x3Maps* maps, const float* x, const float* planes,
                                      int m, int n, int k) {
  const size_t plane = static_cast<size_t>(n) * static_cast<size_t>(k);
  cudaError_t err = encode_f32_rows(&maps->x, x, m, k, kTf32x3TileRows);
  if (err == cudaSuccess) err = encode_f32_rows(&maps->hi, planes, n, k, kTf32x3TileCols);
  if (err == cudaSuccess) err = encode_f32_rows(&maps->lo, planes + plane, n, k, kTf32x3TileCols);
  return err;
}

// ep(x @ W^T) for x described by x_map (boxes of kTf32x3TileRows rows) and
// W by its planes' hi_map, lo_map (boxes of kTf32x3TileCols rows): see the
// note at the head.
template <class Epilogue>
__global__ void __launch_bounds__(kTf32x3Threads, 1)
    tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap hi_map,
                       const __grid_constant__ CUtensorMap lo_map, Epilogue ep, int m, int n,
                       int k) {
  extern __shared__ uint8_t shared_raw[];
  const uint32_t raw = shared_address(shared_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = shared_raw + (ring - raw);
  const uint32_t lo0 = ring + kTf32x3Stages * kTf32x3StageBytes;
  const uint32_t full0 = lo0 + kTf32x3LoBytes;
  const uint32_t empty0 = full0 + 8 * kTf32x3Stages;  // stage s: full0 + 8s, empty0 + 8s

  const int tiles_n = (n + kTf32x3TileCols - 1) / kTf32x3TileCols;
  const int tiles = (m + kTf32x3TileRows - 1) / kTf32x3TileRows * tiles_n;
  const int steps = (k + kTf32x3Depth - 1) / kTf32x3Depth;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTf32x3Stages; ++s) {
      mbarrier_init(full0 + 8 * s, 1);
      mbarrier_init(empty0 + 8 * s, kTf32x3EmptyArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every load
    warpgroup_registers_down<kTf32x3ProducerRegisters>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&x_map);
      prefetch_tensor_map(&hi_map);
      prefetch_tensor_map(&lo_map);
      int pos = 0;  // the ring position of the next k-step: stage pos % S, round pos / S
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / tiles_n * kTf32x3TileRows;
        const int col0 = tile % tiles_n * kTf32x3TileCols;
        for (int j = 0; j < steps; ++j, ++pos) {
          const int stage = pos % kTf32x3Stages;
          mbarrier_wait(empty0 + 8 * stage, ((pos / kTf32x3Stages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * stage, s_at = ring + stage * kTf32x3StageBytes;
          mbarrier_arrive_expect_tx(full, kTf32x3StageBytes);
          tma_load_2d(s_at, &x_map, full, j * kTf32x3Depth, row0);
          tma_load_2d(s_at + kTf32x3XBytes, &hi_map, full, j * kTf32x3Depth, col0);
          tma_load_2d(s_at + kTf32x3XBytes + kTf32x3WBytes, &lo_map, full, j * kTf32x3Depth,
                      col0);
        }
      }
    }
  } else {
    warpgroup_registers_up<kTf32x3ConsumerRegisters>();
    const int consumer = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3, mine = threadIdx.x & 127;
    // every tile of the block, i-th in its walk; this consumer's 64 rows of it
    int i = 0, turn = 0;  // turn: which of the consumer's two lo buffers the step takes
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int row0 = tile / tiles_n * kTf32x3TileRows + consumer * kTile;
      const int col0 = tile % tiles_n * kTf32x3TileCols;
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      int pos = i * steps;  // the producer loaded the block's tiles in order, `steps` each
      for (int j = 0; j < steps; ++j, ++pos, turn ^= 1) {
        const int stage = pos % kTf32x3Stages;
        mbarrier_wait(full0 + 8 * stage, (pos / kTf32x3Stages) & 1);
        // this consumer's 64 rows of x: the raw values become the hi plane in
        // place, the lo plane goes to a buffer of its own (the one the step
        // before last took, whose products every warp has waited for)
        const uint32_t x_off = stage * kTf32x3StageBytes + consumer * kTileBytes;
        const uint32_t lo_off = lo0 - ring + (2 * consumer + turn) * kTileBytes;
        float4* x_hi = reinterpret_cast<float4*>(ring_ptr + x_off);
        float4* x_lo = reinterpret_cast<float4*>(ring_ptr + lo_off);
#pragma unroll
        for (int q = 0; q < kTileBytes / 16 / 128; ++q) {
          float4 hi, lo;
          split_tf32(x_hi[mine + 128 * q], hi, lo);
          x_hi[mine + 128 * q] = hi;
          x_lo[mine + 128 * q] = lo;
        }
        fence_proxy_async();
        named_barrier_sync(1 + consumer, 128);  // the consumer's planes are whole
        const uint32_t w_s = ring + stage * kTf32x3StageBytes + kTf32x3XBytes;
        float chunk[64];
        fence_registers(chunk);
        wgmma_fence();
        tf32x3_product<kTf32x3TileCols, kTf32x3Depth / 8>(chunk, ring + x_off, ring + lo_off,
                                                          w_s, w_s + kTf32x3WBytes, 0, 0, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(chunk);
        add_chunk(acc, chunk);
        __syncwarp();
        if (lane == 0) mbarrier_arrive(empty0 + 8 * stage);  // the stage goes back
      }
      // the epilogue straight from the accumulator layout: a thread's two
      // adjacent columns of each n8 piece, both rows of it
#pragma unroll
      for (int nt = 0; nt < kTf32x3TileCols / 8; ++nt) {
        const int c = col0 + nt * 8 + 2 * tig;
        if (c >= n) continue;
        const bool pair = c + 1 < n;
        const auto cols = ep.columns(c, pair);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + warp * 16 + g + 8 * h;
          if (row >= m) continue;
          const float2 y =
              ep.apply(cols, row, c, pair, acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
          store_pair(ep.out, n, row, c, y.x, y.y, pair);
        }
      }
    }
  }
}

// ep(x @ W^T) on stream s, x and W's planes as `maps` describe them: one
// launch.
template <class Epilogue>
cudaError_t launch_tf32x3_gemm(const Tf32x3Maps& maps, Epilogue ep, int m, int n, int k,
                               cudaStream_t s) {
  auto kernel = tf32x3_gemm_kernel<Epilogue>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kTf32x3SharedBytes);
  if (err != cudaSuccess) return err;
  const int tiles =
      (m + kTf32x3TileRows - 1) / kTf32x3TileRows * ((n + kTf32x3TileCols - 1) / kTf32x3TileCols);
  const int sms = multiprocessors();
  kernel<<<tiles < sms ? tiles : sms, kTf32x3Threads, kTf32x3SharedBytes, s>>>(
      maps.x, maps.hi, maps.lo, ep, m, n, k);
  return cudaGetLastError();
}

constexpr int kSplitTile = 32;  // a split_tf32_t_kernel block's k rows and n columns
constexpr int kSplitThreads = 256;

// planes (2, N, K) = the TF32 split of w^T for a dense (in, out) weight w
// (K, N) f32: hi = tf32(w[k, n]) at planes[n, k], lo = tf32(w[k, n] - hi)
// one plane (N * K floats) further on. A block moves a 32 x 32 piece through
// shared memory: it reads 32 rows of w, a warp 128 contiguous bytes a row,
// and writes 32 rows of each plane, likewise. Any K and N; past them
// nothing is read or written.
__global__ void __launch_bounds__(kSplitThreads)
    split_tf32_t_kernel(const float* __restrict__ w, float* __restrict__ planes, int k, int n) {
  __shared__ float piece[kSplitTile][kSplitTile + 1];
  const int k0 = blockIdx.y * kSplitTile, n0 = blockIdx.x * kSplitTile;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
#pragma unroll
  for (int r = row; r < kSplitTile; r += kSplitThreads / 32) {
    if (k0 + r < k && n0 + lane < n) {
      piece[r][lane] = w[static_cast<size_t>(k0 + r) * n + n0 + lane];
    }
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(n) * static_cast<size_t>(k);
#pragma unroll
  for (int r = row; r < kSplitTile; r += kSplitThreads / 32) {
    if (n0 + r < n && k0 + lane < k) {
      float hi, lo;
      split_tf32(piece[lane][r], hi, lo);
      const size_t at = static_cast<size_t>(n0 + r) * k + k0 + lane;
      planes[at] = hi;
      planes[plane + at] = lo;
    }
  }
}

// planes (2, N, K) = split(w^T) for w (K, N) on stream s
inline cudaError_t launch_split_tf32_t(const float* w, float* planes, int k, int n,
                                       cudaStream_t s) {
  const dim3 grid((n + kSplitTile - 1) / kSplitTile, (k + kSplitTile - 1) / kSplitTile);
  split_tf32_t_kernel<<<grid, kSplitThreads, 0, s>>>(w, planes, k, n);
  return cudaGetLastError();
}

// ep(x (M, K) @ w) for a dense (in, out) weight w (K, N): the maps, then
// two launches on s: w's planes into `planes` (2 N K floats), the GEMM on
// them
template <class Epilogue>
cudaError_t launch_f32_linear(const float* x, const float* w, float* planes, Epilogue ep, int m,
                              int n, int k, cudaStream_t s) {
  Tf32x3Maps maps;
  cudaError_t err = encode_tf32x3_maps(&maps, x, planes, m, n, k);
  if (err == cudaSuccess) err = launch_split_tf32_t(w, planes, k, n, s);
  if (err != cudaSuccess) return err;
  return launch_tf32x3_gemm(maps, ep, m, n, k, s);
}

}  // namespace
}  // namespace dinov2
