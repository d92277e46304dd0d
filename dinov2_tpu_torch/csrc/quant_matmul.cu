// K7 on Hopper: the dequant-matmul,
//
//     y (M, N) = act(x (M, K) @ dequant(W)^T + bias)
//
// for an (N, K) ggml-quantized weight W (models/params.py::QuantLinear),
// packed planes or int8 SoA, in any of q4_0, q4_1, q5_0, q5_1 and q8_0.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/pallas_qmatmul.py::
// _make_kernel_sym, _make_kernel_affine and _make_packed_kernel, reached
// through quant_matmul_pallas.
//
// Picked by x's type:
//   - bf16 x (fc1, fc2; qkv and proj on the flash route): two launches.
//       1. dequant_weight_kernel (dequant_tile.cuh; K8 launches it too, once
//          for each of its weights) turns the whole weight into W (N, K) bf16
//          once per call, in a scratch buffer the caller allocated (at most
//          one layer's weight: 4.7 MB at ViT-B's fc1), in dequant_weight's
//          order (code -> f32, * d, + m, one bf16 cast; QuantWeight), bit
//          for bit dequant_weight(W, bf16). A thread reads 16 bytes of codes
//          and writes 16-byte pieces of W.
//       2. wgmma_gemm.cuh's GEMM on that (N, K) weight as the k-major B
//          operand (the layout of a QuantLinear: no transposed copy), 128 x
//          256 output tiles on a 4-stage cp.async ring, with ActEpilogue
//          (gemm_core.cuh; one instantiation per activation, picked once a
//          launch), the TPU kernel's _epilogue order: bf16(acc),
//          + bf16(bias), then the activation in f32 on the bf16 value,
//          rounded to bf16. gelu_tanh_f16 rounds its input and its output to
//          f16 around PyTorch's tanh formula. Any N: the weight's rows past
//          N are zero-filled in shared memory and the epilogue writes only
//          the columns < N (value by value where N % 8 != 0).
//     The TPU kernel likewise dequantizes each weight tile once and reuses
//     it across all of M. The held weights stay packed; the scratch lives
//     for one call.
//   - f32 x (fc1, fc2 and the head of an f32 quantized run): two launches,
//     3xTF32 on the tensor cores (tf32x3.cuh), as dequant_weight(W, f32)
//     and an f32 matmul compute it.
//       1. dequant_weight_kernel<Tf32SplitRows> turns the weight into its
//          f32 values in dequant_weight's order and writes their two TF32
//          planes, hi and lo, (2, N, K) K-major, into a scratch the caller
//          allocated (18.9 MB at ViT-B's fc1). For q4_0, q5_0 and q8_0 hi +
//          lo is the f32 value bit for bit.
//       2. quant_matmul_tf32x3_kernel: persistent and warp-specialised, as
//          K9's GEMM (int8_matmul.cu). One block an SM walks 128 x 128
//          output tiles, N-fastest. A producer warpgroup's one thread keeps
//          TMA loads (tma_pipeline.cuh) of each 32-deep k-step in flight
//          through a 4-stage mbarrier ring: x's 128 rows (row-major, so
//          K-major as wgmma wants A) and the 128 weight rows of each plane
//          (the K-major B operand as it lies), all 128-byte swizzled, rows
//          past M or N landing as zeros. Two consumer warpgroups own 64 rows
//          each: a consumer splits its x rows once they land, hi in place and
//          lo into a buffer of its own (two, taken in turn), then runs the
//          step's 12 wgmma m64n128k8 (three products of four k8 steps) into a
//          fresh chunk accumulator, waits for them and adds the chunk to its
//          f32 sum with rounded adds (tf32x3.cuh's note: the tensor cores
//          truncate as they sum). The epilogue keeps the FFMA kernel's order,
//          act(acc + bias) in f32, and writes a thread's column pairs from
//          the accumulator layout, masked at M and N (the head has N =
//          1000), while the producer already loads the next tile.
// K is a multiple of 64, and of 128 for packed weights (a k-step lies inside
// one plane).
//
// What bounds it on an H100: at the classify path's fc1 (M=16448, K=768,
// N=3072) a call is 78 GFLOP and reads 1.2 MB of q4_0 weight (4.7 MB in
// bf16), 25 MB of x and writes 101 MB of y: compute-bound, ~0.08 ms at the
// card's bf16 peak. Dequantizing once adds 1.2 MB read and 4.7 MB written
// and read again (~5 us of HBM time). In f32 the same 78 GFLOP take 0.47 ms
// at 3xTF32's 165 TFLOP/s (1.16 ms at the 67 TFLOP/s of FFMA), against
// 0.09 ms for 25 MB of x, 202 MB of y and the 18.9 MB of planes written and
// read: the products bind it. Each k-step a block reads 48 KB of shared
// memory through the TMA for 3 x 2 x 128 x 128 x 32 operations.

#include "dequant_tile.cuh"
#include "tf32x3.cuh"
#include "tma_pipeline.cuh"
#include "wgmma_gemm.cuh"

// The f32 kernels sit in dinov2's unnamed namespace, as the headers' kernels
// do: kernels in a second unnamed namespace at file scope make nvcc's host
// stubs ambiguous.
namespace dinov2 {
namespace {

constexpr int kQf32Depth = kTf32AtomFloats;  // k of a step: one 128-byte swizzle row of f32
constexpr int kQf32Consumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kQf32TileRows = 64 * kQf32Consumers;
constexpr int kQf32TileCols = 128;           // wgmma m64n128k8
constexpr int kQf32Stages = 4;
constexpr int kQf32XBytes = kQf32TileRows * 128;  // x's rows of a step, raw, then its hi plane
constexpr int kQf32WBytes = kQf32TileCols * 128;  // one plane of the weight's rows of a step
constexpr int kQf32StageBytes = kQf32XBytes + 2 * kQf32WBytes;
// x's lo plane: a consumer's 64 rows, two buffers taken in turn by the steps
constexpr int kQf32LoBytes = 2 * kQf32Consumers * kTileBytes;
constexpr int kQf32Threads = 128 * (1 + kQf32Consumers);  // the producer warpgroup first
constexpr int kQf32EmptyArrivals = 4 * kQf32Consumers;    // a warp each
constexpr int kQf32ProducerRegisters = 40, kQf32ConsumerRegisters = 232;
constexpr int kQf32SharedBytes =
    1024 + kQf32Stages * kQf32StageBytes + kQf32LoBytes + 2 * 8 * kQf32Stages;
static_assert(kQf32SharedBytes <= 232448, "the ring, x's lo planes and the barriers fit");
static_assert(128 * kQf32ProducerRegisters + 128 * kQf32Consumers * kQf32ConsumerRegisters <=
                  65536,
              "the registers the warpgroups hold after setmaxnreg exist");

// out (M, N) f32 = act(x (M, K) f32 @ W^T + bias) for W given as its TF32
// planes (2, N, K), described by x_map (boxes of kQf32TileRows rows) and
// hi_map, lo_map (boxes of kQf32TileCols rows): see the note at the head.
template <int kAct>
__global__ void __launch_bounds__(kQf32Threads, 1)
    quant_matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap x_map,
                               const __grid_constant__ CUtensorMap hi_map,
                               const __grid_constant__ CUtensorMap lo_map,
                               const float* __restrict__ bias, float* __restrict__ out, int m,
                               int n, int k) {
  extern __shared__ uint8_t shared_raw[];
  const uint32_t raw = shared_address(shared_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = shared_raw + (ring - raw);
  const uint32_t lo0 = ring + kQf32Stages * kQf32StageBytes;
  const uint32_t full0 = lo0 + kQf32LoBytes;
  const uint32_t empty0 = full0 + 8 * kQf32Stages;  // stage s: full0 + 8s, empty0 + 8s

  const int tiles_n = (n + kQf32TileCols - 1) / kQf32TileCols;
  const int tiles = (m + kQf32TileRows - 1) / kQf32TileRows * tiles_n;
  const int steps = k / kQf32Depth;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kQf32Stages; ++s) {
      mbarrier_init(full0 + 8 * s, 1);
      mbarrier_init(empty0 + 8 * s, kQf32EmptyArrivals);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every load
    warpgroup_registers_down<kQf32ProducerRegisters>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&x_map);
      prefetch_tensor_map(&hi_map);
      prefetch_tensor_map(&lo_map);
      int pos = 0;  // the ring position of the next k-step: stage pos % S, round pos / S
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / tiles_n * kQf32TileRows, col0 = tile % tiles_n * kQf32TileCols;
        for (int j = 0; j < steps; ++j, ++pos) {
          const int stage = pos % kQf32Stages;
          mbarrier_wait(empty0 + 8 * stage, ((pos / kQf32Stages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * stage, s_at = ring + stage * kQf32StageBytes;
          mbarrier_arrive_expect_tx(full, kQf32StageBytes);
          tma_load_2d(s_at, &x_map, full, j * kQf32Depth, row0);
          tma_load_2d(s_at + kQf32XBytes, &hi_map, full, j * kQf32Depth, col0);
          tma_load_2d(s_at + kQf32XBytes + kQf32WBytes, &lo_map, full, j * kQf32Depth, col0);
        }
      }
    }
  } else {
    warpgroup_registers_up<kQf32ConsumerRegisters>();
    const int consumer = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3, mine = threadIdx.x & 127;
    // every tile of the block, i-th in its walk; this consumer's 64 rows of it
    int i = 0, turn = 0;  // turn: which of the consumer's two lo buffers the step takes
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int row0 = tile / tiles_n * kQf32TileRows + consumer * kTile;
      const int col0 = tile % tiles_n * kQf32TileCols;
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      int pos = i * steps;  // the producer loaded the block's tiles in order, `steps` each
      for (int j = 0; j < steps; ++j, ++pos, turn ^= 1) {
        const int stage = pos % kQf32Stages;
        mbarrier_wait(full0 + 8 * stage, (pos / kQf32Stages) & 1);
        // this consumer's 64 rows of x: the raw values become the hi plane in
        // place, the lo plane goes to a buffer of its own (the one the step
        // before last took, whose products every warp has waited for)
        const uint32_t x_off = stage * kQf32StageBytes + consumer * kTileBytes;
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
        const uint32_t w_s = ring + stage * kQf32StageBytes + kQf32XBytes;
        float chunk[64];
        fence_registers(chunk);
        wgmma_fence();
        tf32x3_product<kQf32TileCols, kQf32Depth / 8>(chunk, ring + x_off, ring + lo_off, w_s,
                                                      w_s + kQf32WBytes, 0, 0, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(chunk);
        add_chunk(acc, chunk);
        __syncwarp();
        if (lane == 0) mbarrier_arrive(empty0 + 8 * stage);  // the stage goes back
      }
      // act(acc + bias) in f32, straight from the accumulator layout: a
      // thread's two adjacent columns as one 8-byte store where N is even
#pragma unroll
      for (int nt = 0; nt < kQf32TileCols / 8; ++nt) {
        const int c = col0 + nt * 8 + 2 * tig;
        if (c >= n) continue;
        const bool pair = c + 1 < n;
        const float b0 = bias ? bias[c] : 0.f, b1 = bias && pair ? bias[c + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + warp * 16 + g + 8 * h;
          if (row >= m) continue;
          float y0 = acc[4 * nt + 2 * h], y1 = acc[4 * nt + 2 * h + 1];
          if (bias) y0 += b0, y1 += b1;
          y0 = activate(y0, kAct);
          y1 = activate(y1, kAct);
          float* dst = out + static_cast<size_t>(row) * n + c;
          if (pair && n % 2 == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          } else {
            dst[0] = y0;
            if (pair) dst[1] = y1;
          }
        }
      }
    }
  }
}

template <int kAct>
cudaError_t launch_quant_matmul_tf32x3(const CUtensorMap& x_map, const CUtensorMap& hi_map,
                                       const CUtensorMap& lo_map, const float* bias, float* out,
                                       int m, int n, int k, cudaStream_t s) {
  auto kernel = quant_matmul_tf32x3_kernel<kAct>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kQf32SharedBytes);
  if (err != cudaSuccess) return err;
  const int tiles =
      (m + kQf32TileRows - 1) / kQf32TileRows * ((n + kQf32TileCols - 1) / kQf32TileCols);
  const int sms = multiprocessors();
  kernel<<<tiles < sms ? tiles : sms, kQf32Threads, kQf32SharedBytes, s>>>(
      x_map, hi_map, lo_map, bias, out, m, n, k);
  return cudaGetLastError();
}

// The f32 path's two launches: the weight's TF32 planes into `planes` (2, N,
// K), then the 3xTF32 GEMM on them.
cudaError_t quant_matmul_f32(const float* x, const QuantWeight& w, const float* bias,
                             int activation, float* out, int m, float* planes, cudaStream_t s) {
  if (planes == nullptr) return cudaErrorInvalidValue;
  CUtensorMap x_map, hi_map, lo_map;
  const size_t plane = static_cast<size_t>(w.n) * static_cast<size_t>(w.k);
  cudaError_t err = encode_f32_rows(&x_map, x, m, w.k, kQf32TileRows);
  if (err == cudaSuccess) err = encode_f32_rows(&hi_map, planes, w.n, w.k, kQf32TileCols);
  if (err == cudaSuccess) err = encode_f32_rows(&lo_map, planes + plane, w.n, w.k, kQf32TileCols);
  if (err != cudaSuccess) return err;
  err = launch_dequant_weight_split(w, planes, s);
  if (err != cudaSuccess) return err;
  switch (activation) {
    case kGeluTanhF16:
      return launch_quant_matmul_tf32x3<kGeluTanhF16>(x_map, hi_map, lo_map, bias, out, m, w.n,
                                                      w.k, s);
    case kGeluErf:
      return launch_quant_matmul_tf32x3<kGeluErf>(x_map, hi_map, lo_map, bias, out, m, w.n, w.k,
                                                  s);
    case kGeluTanh:
      return launch_quant_matmul_tf32x3<kGeluTanh>(x_map, hi_map, lo_map, bias, out, m, w.n,
                                                   w.k, s);
    default:
      return launch_quant_matmul_tf32x3<kNone>(x_map, hi_map, lo_map, bias, out, m, w.n, w.k, s);
  }
}

}  // namespace
}  // namespace dinov2

extern "C" {

// y = act(x @ dequant(W)^T + bias) on `stream`. x (M, K) is bf16 (x_f32 ==
// 0) or f32, y (M, N) the same type. W comes as codes, d, m (null for
// q4_0/q5_0/q8_0), qh_lo and qh_hi (null but for packed q5), its layout
// (packed) and zero point. bias (N,) f32 may be null; activation is 0 none,
// 1 gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh (another code returns
// cudaErrorInvalidValue before any launch). weight_scratch: an (N, K) bf16
// buffer for bf16 x, a (2, N, K) f32 one for f32 x, the caller's
// (dequantize, then the GEMM: two launches). Requires K % 64 == 0 (packed:
// K/2 % 64 == 0), 16-byte aligned pointers, and the tensors' device current
// on the calling thread. Returns the first launch's error, else
// cudaGetLastError() after the last.
int dinov2_quant_matmul(const void* x, int x_f32, const void* codes, const void* d,
                        const void* mins, const void* qh_lo, const void* qh_hi, int packed,
                        int zero, const void* bias, int activation, void* out, int m, int n,
                        int k, void* stream, void* weight_scratch) {
  using namespace dinov2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QuantWeight w = quant_weight(codes, d, mins, qh_lo, qh_hi, packed, zero, n, k);
  if (activation < kNone || activation > kGeluTanh) return cudaErrorInvalidValue;
  if (x_f32) {
    return quant_matmul_f32(static_cast<const float*>(x), w, static_cast<const float*>(bias),
                            activation, static_cast<float*>(out), m,
                            static_cast<float*>(weight_scratch), s);
  }
  bf16* dense = static_cast<bf16*>(weight_scratch);
  const cudaError_t err = launch_dequant_weight(w, dense, s);
  if (err != cudaSuccess) return err;
  const float* bias_ = static_cast<const float*>(bias);
  bf16* out_ = static_cast<bf16*>(out);
  auto gemm = [&](auto ep) {
    return launch_wgmma_gemm<true>(static_cast<const bf16*>(x), dense, ep, m, n, k, s);
  };
  switch (activation) {
    case kGeluTanhF16:
      return gemm(ActEpilogue<kGeluTanhF16>{bias_, out_, n});
    case kGeluErf:
      return gemm(ActEpilogue<kGeluErf>{bias_, out_, n});
    case kGeluTanh:
      return gemm(ActEpilogue<kGeluTanh>{bias_, out_, n});
    default:
      return gemm(ActEpilogue<kNone>{bias_, out_, n});
  }
}

// W (N, K) bf16 = dequant_weight(W, bf16), bit for bit: the first of the bf16
// path's two launches alone, on `stream`. The arguments as above; out is an
// (N, K) bf16 buffer.
int dinov2_dequant_weight_bf16(const void* codes, const void* d, const void* mins,
                               const void* qh_lo, const void* qh_hi, int packed, int zero,
                               void* out, int n, int k, void* stream) {
  using namespace dinov2;
  return launch_dequant_weight(quant_weight(codes, d, mins, qh_lo, qh_hi, packed, zero, n, k),
                               static_cast<bf16*>(out), static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
