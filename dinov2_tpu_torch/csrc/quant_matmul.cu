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
//       2. tf32x3_gemm.cuh's persistent, warp-specialised 3xTF32 GEMM
//          (tf32x3_gemm_kernel), which every f32 kernel of the port shares:
//          one block an SM walks 128 x 128 output tiles, a producer's TMA
//          loads of x and the two planes through a 4-stage mbarrier ring,
//          two consumer warpgroups splitting x where it lands and running
//          wgmma m64n128k8 .tf32 in 32-deep chunks, each chunk added to the
//          f32 sum with rounded adds. Its epilogue here is F32Act: act(acc +
//          bias) in f32, written a thread's column pairs at a time from the
//          accumulator layout, masked at M and N (the head has N = 1000).
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
#include "tf32x3_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace dinov2 {
namespace {

// The f32 path's two launches: the weight's TF32 planes into `planes` (2, N,
// K), then the 3xTF32 GEMM on them with act(acc + bias).
cudaError_t quant_matmul_f32(const float* x, const QuantWeight& w, const float* bias,
                             int activation, float* out, int m, float* planes, cudaStream_t s) {
  if (planes == nullptr) return cudaErrorInvalidValue;
  Tf32x3Maps maps;
  cudaError_t err = encode_tf32x3_maps(&maps, x, planes, m, w.n, w.k);
  if (err == cudaSuccess) err = launch_dequant_weight_split(w, planes, s);
  if (err != cudaSuccess) return err;
  auto gemm = [&](auto ep) { return launch_tf32x3_gemm(maps, ep, m, w.n, w.k, s); };
  switch (activation) {
    case kGeluTanhF16:
      return gemm(F32Act<kGeluTanhF16>{bias, out, w.n});
    case kGeluErf:
      return gemm(F32Act<kGeluErf>{bias, out, w.n});
    case kGeluTanh:
      return gemm(F32Act<kGeluTanh>{bias, out, w.n});
    default:
      return gemm(F32Act<kNone>{bias, out, w.n});
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
