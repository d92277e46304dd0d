// K5 on Hopper: the whole MLP half-layer of a DINOv2 encoder layer,
//
//     out = x + ls2 * (fc2(act(fc1(LN2(x)) + b1)) + b2)
//
// for x (B, T, D) bf16 taken as M = B*T independent rows, w1 (D, 4D) and
// w2 (4D, D) bf16 stored (in, out), LN scale/bias, biases and LayerScale as
// f32 rows, act one of gelu_tanh_f16, gelu_erf, gelu_tanh.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/fused_attention.py::
// _slab_mlp_kernel (per image) and _slab_mlp_flat_kernel (flattened rows),
// reached through slab_mlp_block. The half-layer is row-independent, so one
// entry over the flattened rows covers both.
//
// What bounds it on an H100: at the main path's shape (B=64, T=257, D=768,
// DH=3072) one call is 4*M*D*DH = 155 GFLOP over 25 MB of x in, 25 MB out
// and 9.4 MB of weights: operations bind it, ~0.157 ms at 989 TFLOP/s bf16
// (the bytes take ~0.018 ms at 3.35 TB/s).
//
// Design: three launches on the caller's stream, K1's building blocks
// (wgmma_gemm.cuh):
//   0. layer_norm_rows_kernel: LN2 of every row, once, a warp a row, written
//      as bf16 into `out`, which nothing reads again once fc1 has read it
//      and which fc2 writes last.
//   1. wgmma_gemm_kernel<ActEpilogue<act>>: LN2(x) @ w1, 128 x 256 output
//      tiles on a 4-stage cp.async ring, wgmma m64n128k16; epilogue
//      act(bf16(acc) + bf16(b1)) -> the (M, DH) hidden buffer in HBM, one
//      instantiation per activation.
//   2. wgmma_gemm_kernel<ResidualEpilogue>: hidden @ w2, accumulated in f32
//      over the whole hidden axis; epilogue bf16(acc) + bf16(b2), *
//      bf16(ls2), + x, each step rounded to bf16.
// The TPU kernel keeps the hidden activation on chip; here it goes through
// HBM, 2*M*DH bytes written once and read once (101 MB, ~0.06 ms of HBM time
// at the main shape, against ~0.3 ms of products). Keeping it on chip (fc1
// chunks shared across a cluster through distributed shared memory, fc2's
// accumulator split by columns) is left for later work.
//
// Numerics follow the JAX package's cast points (fused_attention.py:859-883):
// f32 LN statistics in two passes, LN affine in f32 without fused
// multiply-add, then one bf16 cast; fc1 accumulated in f32, cast to bf16
// before the bias add, the activation applied to that bf16 value in f32 and
// rounded to bf16 (gelu_tanh_f16 through f16 on both sides, activation.cuh,
// shared with K7); fc2 accumulated in f32 over all of DH.
//
// The f32 entry (dinov2_slab_mlp_f32) runs the same half-layer on f32
// activations and f32 (in, out) weights, with the JAX package's f32
// numerics (every cast to the compute dtype a no-op; fused_attention.py:
// 870-883), in five launches: f32_gemm.cuh's layer norm into `out`; the
// TF32 planes of w1, split and transposed into a scratch the caller
// allocated; fc1 on tf32x3_gemm.cuh's 3xTF32 core with F32Act (act(acc +
// b1), the activation on the f32 sum) into an (M, DH) f32 hidden buffer;
// w2's planes over w1's; fc2 with F32Residual (x + (acc + b2) * ls2, each
// step rounded once). At the main path's shape its 155 GFLOP are 0.94 ms at
// 3xTF32's 165 TFLOP/s: operations bind it; the f32 hidden buffer (202 MB,
// written once and read once) is ~0.12 ms of HBM time, the planes (18.9
// MB each) ~6 us.
//
// Each entry point returns the first launch's error, else
// cudaGetLastError() after the last.

#include "f32_gemm.cuh"
#include "wgmma_gemm.cuh"

extern "C" {

// The whole MLP half-layer, three launches on `stream`: x and out (M, D)
// bf16, w1 (D, DH) and w2 (DH, D) bf16, the rest f32 rows; activation 1
// gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh; hidden_scratch an (M, DH) bf16
// buffer the caller allocated. Requires D in {384, 768, 1024}, DH == 4 * D
// and one of those activations (anything else returns cudaErrorInvalidValue
// before any launch), 16-byte aligned pointers, and the tensors' device
// current on the calling thread.
int dinov2_slab_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* ls2, void* out, int m, int d, int dh, int activation,
                         float eps, void* stream, void* hidden_scratch) {
  using namespace dinov2;
  if (dh != 4 * d || m <= 0 || (d != 384 && d != 768 && d != 1024) ||
      activation < kGeluTanhF16 || activation > kGeluTanh) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x_ = static_cast<const bf16*>(x);
  const float* b1_ = static_cast<const float*>(b1);
  bf16* out_ = static_cast<bf16*>(out);
  bf16* hidden = static_cast<bf16*>(hidden_scratch);
  auto fc1 = [&](auto ep) {
    return launch_wgmma_gemm(out_, static_cast<const bf16*>(w1), ep, m, dh, d, s);
  };

  cudaError_t err = launch_layer_norm_rows(x_, static_cast<const float*>(ln_scale),
                                           static_cast<const float*>(ln_bias), out_, m, d, eps, s);
  if (err != cudaSuccess) return err;
  switch (activation) {
    case kGeluTanhF16:
      err = fc1(ActEpilogue<kGeluTanhF16>{b1_, hidden, dh});
      break;
    case kGeluErf:
      err = fc1(ActEpilogue<kGeluErf>{b1_, hidden, dh});
      break;
    default:
      err = fc1(ActEpilogue<kGeluTanh>{b1_, hidden, dh});
  }
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm(
      hidden, static_cast<const bf16*>(w2),
      ResidualEpilogue{static_cast<const float*>(b2), static_cast<const float*>(ls2), x_, out_, d},
      m, d, dh, s);
}

// The same half-layer in f32: x, w1, w2, out and hidden_scratch f32, the
// rest as above; weight_scratch holds 2 D DH floats, the TF32 planes of one
// weight at a time. Requires D % 16 == 0 (any width), DH == 4 * D and one
// of the three activations (anything else returns cudaErrorInvalidValue
// before any launch), 16-byte aligned pointers, and the tensors' device
// current on the calling thread.
int dinov2_slab_mlp_f32(const void* x, const void* ln_scale, const void* ln_bias,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* ls2, void* out, int m, int d, int dh, int activation,
                        float eps, void* stream, void* hidden_scratch, void* weight_scratch) {
  using namespace dinov2;
  if (dh != 4 * d || m <= 0 || d <= 0 || d % 16 || activation < kGeluTanhF16 ||
      activation > kGeluTanh) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x_ = static_cast<const float*>(x);
  const float* b1_ = static_cast<const float*>(b1);
  float* out_ = static_cast<float*>(out);
  float* hidden = static_cast<float*>(hidden_scratch);
  float* planes = static_cast<float*>(weight_scratch);
  auto fc1 = [&](auto ep) {
    return launch_f32_linear(out_, static_cast<const float*>(w1), planes, ep, m, dh, d, s);
  };

  cudaError_t err = launch_f32_layer_norm_rows(x_, static_cast<const float*>(ln_scale),
                                               static_cast<const float*>(ln_bias), out_, m, d,
                                               eps, s);
  if (err != cudaSuccess) return err;
  switch (activation) {
    case kGeluTanhF16:
      err = fc1(F32Act<kGeluTanhF16>{b1_, hidden, dh});
      break;
    case kGeluErf:
      err = fc1(F32Act<kGeluErf>{b1_, hidden, dh});
      break;
    default:
      err = fc1(F32Act<kGeluTanh>{b1_, hidden, dh});
  }
  if (err != cudaSuccess) return err;
  return launch_f32_linear(
      hidden, static_cast<const float*>(w2), planes,
      F32Residual{static_cast<const float*>(b2), static_cast<const float*>(ls2), x_, out_, d}, m,
      d, dh, s);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
