// The attention half-layer,
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
// as four launches on one stream, shared by K1 (slab_layer.cu, dense bf16
// weights) and K8 (quant_layer.cu, ggml-quantized weights dequantized into a
// scratch first); K2 and K3 (slab_attention.cu) run launch 3 alone, K2 launch
// 4 behind it. The (B, T, 3D) qkv slab and the (B, T, D) attention output go
// through HBM between the launches:
//   1. launch_layer_norm_rows (wgmma_gemm.cuh): LN1 of every row into the
//      attention buffer, which is free until launch 3;
//   2. the QKV GEMM (wgmma_gemm.cuh) with BiasEpilogue: bf16(acc) +
//      bf16(b_qkv) -> qkv slab;
//   3. launch_slab_attention below -> attention output;
//   4. the proj GEMM with ResidualEpilogue: bf16(acc) + bf16(b_proj),
//      * bf16(ls1), + x, each step rounded to bf16.
// The GEMMs take the weights either (in, out) row-major, the dense layout,
// as the mn-major operand through the descriptor's transpose bit, or
// (kKMajorWeight) (out, in) row-major, the layout of a dequantized
// QuantLinear, as the k-major operand. Both add the same k16 products into
// f32 in the same order.
//
// launch_f32_half_layer is the same on f32 activations, shared by K1 f32
// (dense (in, out) weights) and K8 f32 (quantized ones), with the weights'
// TF32 planes written into one scratch just before each GEMM reads them
// (six launches): LN1 (f32_gemm.cuh's layer norm), qkv's planes, the QKV
// GEMM with F32Bias, f32_attention.cuh's tile loop on the slab's head
// views, proj's planes over qkv's, the proj GEMM with F32Residual, both
// GEMMs tf32x3_gemm.cuh's 3xTF32 core. K1 f32 splits and transposes its
// dense weights into the planes (split_tf32_t_kernel), K8 f32 dequantizes
// straight into them (dequant_tile.cuh's Tf32SplitRows); the planes are
// the same f32 values split the same way, so on dequant_weight(W, f32).T
// K1 f32 gives K8 f32's output bit for bit.

#pragma once

#include "f32_attention.cuh"
#include "f32_gemm.cuh"
#include "flash_forward.cuh"
#include "wgmma_gemm.cuh"

namespace dinov2 {
namespace {

// out[b, t, h*64:(h+1)*64] = softmax(q k^T * scale) v per (image, head), read
// straight out of the (B, T, 3D) slab: K4's tile loop (flash_forward.cuh) on
// the slab's head views, q, k and v at column offsets h*64, D + h*64 and
// 2D + h*64, batch stride T*3D, token stride 3D, head stride 64; its
// (B, T, H, 64) output is the (B, T, D) attention output. One launch on s.
inline cudaError_t launch_slab_attention(const bf16* qkv, bf16* out, int b, int t, int d,
                                         int heads, float scale, cudaStream_t s) {
  const long long token_stride = 3LL * d;
  return static_cast<cudaError_t>(launch_forward_by_shape<false>(
      qkv, qkv + d, qkv + 2 * d, out, nullptr, b, t, heads, t * token_stride, token_stride,
      kHeadDim, scale, s));
}

// The four launches on s. w_qkv and w_proj are (D, 3D) and (D, D) or, with
// kKMajorWeight, (3D, D) and (D, D); qkv (B, T, 3D) and attn (B, T, D) are
// scratch the caller allocated. Returns the first launch error.
template <bool kKMajorWeight>
cudaError_t launch_half_layer(const bf16* x, const float* ln_scale, const float* ln_bias,
                              const bf16* w_qkv, const float* b_qkv, const bf16* w_proj,
                              const float* b_proj, const float* ls1, bf16* qkv, bf16* attn,
                              bf16* out, int b, int t, int d, int heads, float scale, float eps,
                              cudaStream_t s) {
  const int m = b * t;
  cudaError_t err = launch_layer_norm_rows(x, ln_scale, ln_bias, attn, m, d, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm<kKMajorWeight>(attn, w_qkv, BiasEpilogue{b_qkv, qkv, 3 * d}, m, 3 * d,
                                         d, s);
  if (err != cudaSuccess) return err;
  err = launch_slab_attention(qkv, attn, b, t, d, heads, scale, s);
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm<kKMajorWeight>(attn, w_proj,
                                          ResidualEpilogue{b_proj, ls1, x, out, d}, m, d, d, s);
}

// A dense f32 half-layer's weights, w_qkv (D, 3D) and w_proj (D, D) stored
// (in, out): each split and transposed into the planes (2, N, D).
struct DenseF32Weights {
  const float* w_qkv;
  const float* w_proj;
  int d;

  cudaError_t qkv(float* planes, cudaStream_t s) const {
    return launch_split_tf32_t(w_qkv, planes, d, 3 * d, s);
  }
  cudaError_t proj(float* planes, cudaStream_t s) const {
    return launch_split_tf32_t(w_proj, planes, d, d, s);
  }
};

// The six f32 launches on s: x, out (B, T, D) f32; weights.qkv and
// weights.proj write the (2, 3D, D) and (2, D, D) TF32 planes of the two
// weights into `planes` (6 D^2 floats, proj's over qkv's once the QKV GEMM
// has read them); qkv (B, T, 3D) and attn (B, T, D) f32 scratch the caller
// allocated (attn holds LN1's rows until the attention launch). D % 4 == 0.
// Encodes both GEMMs' tensor maps first; returns the first error.
template <class Weights>
cudaError_t launch_f32_half_layer(const float* x, const float* ln_scale, const float* ln_bias,
                                  const Weights& weights, const float* b_qkv,
                                  const float* b_proj, const float* ls1, float* planes,
                                  float* qkv, float* attn, float* out, int b, int t, int d,
                                  int heads, float scale, float eps, cudaStream_t s) {
  const int m = b * t;
  Tf32x3Maps qkv_maps, proj_maps;  // both GEMMs read attn: LN1's rows, then the attention
  cudaError_t err = encode_tf32x3_maps(&qkv_maps, attn, planes, m, 3 * d, d);
  if (err == cudaSuccess) err = encode_tf32x3_maps(&proj_maps, attn, planes, m, d, d);
  if (err == cudaSuccess) {
    err = launch_f32_layer_norm_rows(x, ln_scale, ln_bias, attn, m, d, eps, s);
  }
  if (err == cudaSuccess) err = weights.qkv(planes, s);
  if (err == cudaSuccess) {
    err = launch_tf32x3_gemm(qkv_maps, F32Bias{b_qkv, qkv, 3 * d}, m, 3 * d, d, s);
  }
  if (err == cudaSuccess) err = launch_f32_slab_attention(qkv, attn, b, t, d, heads, scale, s);
  if (err == cudaSuccess) err = weights.proj(planes, s);
  if (err != cudaSuccess) return err;
  return launch_tf32x3_gemm(proj_maps, F32Residual{b_proj, ls1, x, out, d}, m, d, d, s);
}

}  // namespace
}  // namespace dinov2
