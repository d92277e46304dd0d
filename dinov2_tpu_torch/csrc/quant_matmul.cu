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
//   - f32 x (the classifier head on f32 features): a plain FMA kernel on
//     f32 tiles, the weight dequantized to f32, as dequant_weight(W, f32)
//     and an f32 matmul compute it; epilogue acc + bias, then the
//     activation. M and N are masked at the edges (the head has N = 1000).
// K is a multiple of 64, and of 128 for packed weights (a k-step lies inside
// one plane).
//
// What bounds it on an H100: at the classify path's fc1 (M=16448, K=768,
// N=3072) a call is 78 GFLOP and reads 1.2 MB of q4_0 weight (4.7 MB in
// bf16), 25 MB of x and writes 101 MB of y: compute-bound, ~0.08 ms at the
// card's bf16 peak. Dequantizing once adds 1.2 MB read and 4.7 MB written
// and read again (~5 us of HBM time).

#include "dequant_tile.cuh"
#include "wgmma_gemm.cuh"

// The f32 kernel sits in dinov2's unnamed namespace, as the headers' kernels
// do: kernels in a second unnamed namespace at file scope make nvcc's host
// stubs ambiguous.
namespace dinov2 {
namespace {

constexpr int kF32Threads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kF32TileK = 32;     // one ggml block of k per step
constexpr int kF32Lds = kTile + 4;

// out (M, N) f32 = act(x (M, K) f32 @ dequant(W)^T + bias), one 64x64 output
// tile per block; k-steps of 32 staged k-major in shared memory.
__global__ void __launch_bounds__(kF32Threads)
    quant_matmul_f32_kernel(const float* __restrict__ x, QuantWeight w,
                            const float* __restrict__ bias, int act, float* __restrict__ out,
                            int m) {
  __shared__ __align__(16) float xs[kF32TileK][kF32Lds];
  __shared__ __align__(16) float ws[kF32TileK][kF32Lds];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  // the piece this thread stages per k-step: tile row r, k offsets c..c+7
  const int r = tid >> 2, c = (tid & 3) * 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < w.k; k0 += kF32TileK) {
    float xv[8], wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = wv[j] = 0.f;
    if (row0 + r < m) {
      const float4* src =
          reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * w.k + k0 + c);
      const float4 lo = src[0], hi = src[1];
      xv[0] = lo.x, xv[1] = lo.y, xv[2] = lo.z, xv[3] = lo.w;
      xv[4] = hi.x, xv[5] = hi.y, xv[6] = hi.z, xv[7] = hi.w;
    }
    if (col0 + r < w.n) w.dequant8(col0 + r, k0 + c, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xs[c + j][r] = xv[j];
      ws[c + j][r] = wv[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32TileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= w.n) continue;
      float y = acc[i][j];
      if (bias) y += bias[col];
      out[static_cast<size_t>(row) * w.n + col] = activate(y, act);
    }
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
// cudaErrorInvalidValue before any launch). weight_scratch: for bf16 x an
// (N, K) bf16 buffer the caller allocated (dequantize, then the GEMM: two
// launches), ignored for f32 x (one launch). Requires K % 64 == 0 (packed:
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
  if (x_f32) {
    const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    quant_matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), w, static_cast<const float*>(bias), activation,
        static_cast<float*>(out), m);
    return cudaGetLastError();
  }
  if (activation < kNone || activation > kGeluTanh) return cudaErrorInvalidValue;
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
