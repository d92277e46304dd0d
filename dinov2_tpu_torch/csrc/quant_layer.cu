// K8 on Hopper: the attention half-layer with ggml-quantized weights,
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
// for x (B, T, D) bf16 and qkv (3D, D) and proj (D, D) as QuantLinear
// weights (models/params.py), packed planes or int8 SoA, in any of q4_0,
// q4_1, q5_0, q5_1 and q8_0; LN scale/bias, biases and LayerScale as f32
// rows; head_dim 64.
//
// Replaces the Pallas TPU kernel dinov2_tpu/ops/fused_quant_attention.py::
// _quant_layer_kernel, reached through slab_layer_block_quant. That kernel
// dequantizes both weights once per call into VMEM scratch and then runs
// the body of the dense half-layer's kernel on them; this one does the same
// with HBM for VMEM:
//   1, 2. dequant_weight_kernel (dequant_tile.cuh, K7's dequantize launch):
//      qkv into rows 0..3D-1 of a (4D, D) bf16 scratch the caller allocated,
//      then proj into rows 3D..4D-1, in dequant_weight's order (code -> f32,
//      * d, + m, one bf16 cast), bit for bit dequant_weight(W, bf16);
//   3-6. K1's four launches (half_layer.cuh::launch_half_layer): LN1, the
//      QKV GEMM, the attention launch, the proj GEMM, on wgmma_gemm.cuh's
//      core with the scratch's two weights as the k-major (out, in) operand,
//      the layout K7 reads too (no transposed copy).
// So K8 computes K1's function on dequant_weight(W, bf16)^T with K1's cast
// points; the two differ only in how a weight tile is staged (k-major rows
// against mn-major atoms through the descriptor's transpose bit).
//
// What bounds it on an H100: at the main path's shape (B=64, T=257, D=768,
// H=12) K1's ~91 GFLOP, ~0.09 ms at 989 TFLOP/s bf16; the packed weights
// are 1.3-2.5 MB against K1's 4.7 MB of bf16. Dequantizing writes the 4.7 MB
// scratch once and the GEMMs read it from L2; the qkv slab (76 MB) and the
// attention output (25 MB) go through HBM as in K1.
//
// The f32 entry (dinov2_quant_layer_f32) is the same on f32 activations,
// with the JAX kernel's f32 numerics (its VMEM scratch is of x's dtype,
// fused_quant_attention.py:139-168, so the weights stay f32): K1 f32's six
// launches (half_layer.cuh::launch_f32_half_layer) with each weight's
// planes written by dequant_weight_kernel<Tf32SplitRows> (K7 f32's
// dequantize launch): code -> f32, * d, + m, no cast, then the TF32 split,
// hi and lo (2, N, D), the K-major layout the 3xTF32 GEMM reads and the
// QuantLinear's own (no transpose). qkv's planes go into the scratch, the
// QKV GEMM reads them, then proj's overwrite them. K1 f32 splits
// dequant_weight(W, f32).T into the same planes, so K8 f32 is bit for bit
// the "dequant" route (models/vit.py: the layer's weights dequantized by
// plain ops, then K1 f32). At the main path's shape K1 f32's ~91 GFLOP bind
// it: 0.55 ms at 3xTF32's 165 TFLOP/s; the scratch is 14.2 MB, written and
// read from L2.

#include "dequant_tile.cuh"
#include "half_layer.cuh"

namespace dinov2 {
namespace {

// K8 f32's weights: each dequantized straight into its TF32 planes.
struct QuantF32Weights {
  QuantWeight qkv_w, proj_w;

  cudaError_t qkv(float* planes, cudaStream_t s) const {
    return launch_dequant_weight_split(qkv_w, planes, s);
  }
  cudaError_t proj(float* planes, cudaStream_t s) const {
    return launch_dequant_weight_split(proj_w, planes, s);
  }
};

}  // namespace
}  // namespace dinov2

extern "C" {

// The whole half-layer, six launches on `stream`. Each weight comes as
// codes, d, m (null for q4_0/q5_0/q8_0), qh_lo and qh_hi (null but for
// packed q5), its layout (packed) and zero point; qkv is (3D, D), proj
// (D, D). qkv_scratch (B, T, 3D), attn_scratch (B, T, D) and weight_scratch
// (4D, D) are bf16 buffers the caller allocated, weight_scratch apart from
// the other two (attn_scratch holds LN1's rows while the QKV GEMM reads the
// weights); out is (B, T, D). Requires D == 64 * heads, D/2 % 64 == 0 for
// packed weights, 16-byte aligned pointers, and the tensors' device current
// on the calling thread. Returns the first launch's error, else
// cudaGetLastError() after the last.
int dinov2_quant_layer_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* qkv_codes, const void* qkv_d, const void* qkv_m,
                            const void* qkv_qh_lo, const void* qkv_qh_hi, int qkv_packed,
                            int qkv_zero, const void* b_qkv, const void* proj_codes,
                            const void* proj_d, const void* proj_m, const void* proj_qh_lo,
                            const void* proj_qh_hi, int proj_packed, int proj_zero,
                            const void* b_proj, const void* ls1, void* qkv_scratch,
                            void* attn_scratch, void* out, int b, int t, int d, int heads,
                            float scale, float eps, void* stream, void* weight_scratch) {
  using namespace dinov2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* w_qkv = static_cast<bf16*>(weight_scratch);
  bf16* w_proj = w_qkv + 3LL * d * d;
  cudaError_t err = launch_dequant_weight(
      quant_weight(qkv_codes, qkv_d, qkv_m, qkv_qh_lo, qkv_qh_hi, qkv_packed, qkv_zero, 3 * d, d),
      w_qkv, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant_weight(quant_weight(proj_codes, proj_d, proj_m, proj_qh_lo, proj_qh_hi,
                                           proj_packed, proj_zero, d, d),
                              w_proj, s);
  if (err != cudaSuccess) return err;
  return launch_half_layer<true>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), w_qkv, static_cast<const float*>(b_qkv), w_proj,
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
      static_cast<bf16*>(qkv_scratch), static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out),
      b, t, d, heads, scale, eps, s);
}

// The same half-layer in f32: x, out, the scratch buffers f32, the weights
// and the rest as above; weight_scratch holds 6 D^2 floats, the TF32
// planes of one weight at a time. Same requirements.
int dinov2_quant_layer_f32(const void* x, const void* ln_scale, const void* ln_bias,
                           const void* qkv_codes, const void* qkv_d, const void* qkv_m,
                           const void* qkv_qh_lo, const void* qkv_qh_hi, int qkv_packed,
                           int qkv_zero, const void* b_qkv, const void* proj_codes,
                           const void* proj_d, const void* proj_m, const void* proj_qh_lo,
                           const void* proj_qh_hi, int proj_packed, int proj_zero,
                           const void* b_proj, const void* ls1, void* qkv_scratch,
                           void* attn_scratch, void* out, int b, int t, int d, int heads,
                           float scale, float eps, void* stream, void* weight_scratch) {
  using namespace dinov2;
  const QuantF32Weights weights{
      quant_weight(qkv_codes, qkv_d, qkv_m, qkv_qh_lo, qkv_qh_hi, qkv_packed, qkv_zero, 3 * d, d),
      quant_weight(proj_codes, proj_d, proj_m, proj_qh_lo, proj_qh_hi, proj_packed, proj_zero, d,
                   d)};
  return launch_f32_half_layer(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), weights, static_cast<const float*>(b_qkv),
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
      static_cast<float*>(weight_scratch), static_cast<float*>(qkv_scratch),
      static_cast<float*>(attn_scratch), static_cast<float*>(out), b, t, d, heads, scale, eps,
      static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
