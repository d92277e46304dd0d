// K1 on Hopper: the whole attention half-layer of a DINOv2 encoder layer,
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
// for x (B, T, D) bf16, w_qkv (D, 3D) and w_proj (D, D) bf16 stored (in, out),
// LN scale/bias, biases and LayerScale as f32 rows, head_dim 64.
//
// Replaces the Pallas TPU kernel dinov2_tpu/ops/fused_attention.py::
// _slab_layer_kernel (softmax core _head_softmax_pv, head loop
// _attention_heads_sliced), reached through slab_layer_block.
//
// What bounds it on an H100: at the main path's shape (B=64, T=257, D=768,
// H=12) one call is ~91 GFLOP: 58 in the QKV GEMM, 19 in proj and 13 in
// attention. The whole 12-layer forward is ~2.9 TFLOP, 1.1 of it here. At
// 989 TFLOP/s bf16 the floor is ~0.09 ms per call; the weights (4.7 MB) and x
// (25 MB in, 25 MB out) are small next to that.
//
// Design: four launches on the caller's stream (half_layer.cuh's
// launch_half_layer, which K8 runs too on its dequantized weights).
//   0. layer_norm_rows_kernel (wgmma_gemm.cuh): LN1 of every row, once, a
//      warp a row, into the attention scratch buffer (free until launch 2).
//   1. wgmma_gemm_kernel<BiasEpilogue>: 128 x 256 output tiles, a cp.async
//      ring of swizzled tiles, wgmma m64n128k16 with w_qkv as the mn-major
//      operand. Epilogue: bf16(acc) + bf16(b_qkv) -> qkv slab (B, T, 3D) in
//      HBM, 16 bytes a lane.
//   2. launch_slab_attention (half_layer.cuh): K4's wgmma tile loop
//      (flash_forward.cuh) on the slab's head views, column offsets h*64,
//      D+h*64 and 2D+h*64 (no head transposes), the ragged tail (T=257 =
//      4*64+1) masked, not padded. Output bf16 into the attention scratch
//      (B, T, D) in HBM. It is K3's kernel.
//   3. wgmma_gemm_kernel<ResidualEpilogue>: attn @ w_proj, epilogue
//      bf16(acc) + bf16(b_proj), * bf16(ls1), + x, each step rounded to bf16.
// The TPU kernel keeps the qkv slab and the attention output on chip; this
// version writes and re-reads both, and LN1's rows too (76 MB of qkv and
// twice 25 MB per call at the main-path shape). Keeping them on chip is left
// for later work.
//
// Numerics follow the JAX package's cast points (fused_attention.py:600-626):
// f32 LN statistics, LN affine in f32 then one bf16 cast; f32-accumulated
// GEMMs cast to bf16 before the bias add; f32 scores and an exact online
// softmax; bf16 P.V with f32 accumulation. The softmax scale multiplies the
// f32 scores inside the exponent (flash_attention.cu's note); the log2(e)
// fold into bf16 q that the TPU kernel makes is not copied.
//
// The f32 entry (dinov2_slab_layer_f32) runs the same half-layer on f32
// activations and f32 weights, with the JAX package's f32 numerics (every
// cast to the compute dtype a no-op): half_layer.cuh's
// launch_f32_half_layer, which K8 f32 runs too, in six launches: LN1, the
// TF32 planes of w_qkv (split and transposed into a scratch the caller
// allocated), the QKV GEMM with the bias epilogue, f32_attention.cuh's
// tile loop on the slab's head views, the planes of w_proj, the proj GEMM
// with the residual epilogue; both GEMMs on tf32x3_gemm.cuh's 3xTF32 core,
// f32-accurate products on the tensor cores. At the main path's shape its
// ~91 GFLOP are 0.55 ms at 3xTF32's 165 TFLOP/s: operations bind it.
//
// Every entry point returns the first launch's error, else
// cudaGetLastError() after the last.

#include "half_layer.cuh"

extern "C" {

// The whole half-layer on `stream`. qkv_scratch (B, T, 3D) and attn_scratch
// (B, T, D) are bf16 buffers the caller allocated (attn_scratch holds LN1's
// rows first, the attention output at the end); out is (B, T, D). Requires
// D == 64 * heads, 16-byte aligned pointers, and the tensors' device current
// on the calling thread (the caller sets it).
int dinov2_slab_layer_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                           const void* w_qkv, const void* b_qkv, const void* w_proj,
                           const void* b_proj, const void* ls1, void* qkv_scratch,
                           void* attn_scratch, void* out, int b, int t, int d, int heads,
                           float scale, float eps, void* stream) {
  using dinov2::bf16;
  return dinov2::launch_half_layer<false>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(w_qkv),
      static_cast<const float*>(b_qkv), static_cast<const bf16*>(w_proj),
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
      static_cast<bf16*>(qkv_scratch), static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out),
      b, t, d, heads, scale, eps, static_cast<cudaStream_t>(stream));
}

// The same half-layer in f32: x, w_qkv, w_proj, the scratch buffers and out
// f32, the rest as above; weight_scratch holds 6 D^2 floats, the TF32
// planes of one weight at a time. D % 64 == 0 (head_dim 64).
int dinov2_slab_layer_f32(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w_qkv, const void* b_qkv, const void* w_proj,
                          const void* b_proj, const void* ls1, void* qkv_scratch,
                          void* attn_scratch, void* out, int b, int t, int d, int heads,
                          float scale, float eps, void* stream, void* weight_scratch) {
  using namespace dinov2;
  return launch_f32_half_layer(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias),
      DenseF32Weights{static_cast<const float*>(w_qkv), static_cast<const float*>(w_proj), d},
      static_cast<const float*>(b_qkv), static_cast<const float*>(b_proj),
      static_cast<const float*>(ls1), static_cast<float*>(weight_scratch),
      static_cast<float*>(qkv_scratch), static_cast<float*>(attn_scratch),
      static_cast<float*>(out), b, t, d, heads, scale, eps, static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
