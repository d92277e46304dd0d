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
// Design of this first version: three launches on the caller's stream
// (half_layer.cuh::launch_half_layer, which K8 runs too, with the GEMM core
// of gemm_core.cuh and dense weight tiles):
//   1. gemm_ln_kernel: per 64-row tile, two-pass f32 LN statistics, then the
//      normalized bf16 rows are made tile by tile in shared memory and
//      multiplied by w_qkv with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//      Epilogue: bf16(acc) + bf16(b_qkv) -> qkv slab (B, T, 3D) in HBM.
//   2. slab_attention_kernel: grid (B*H, ceil(T/64)). Each block holds a 64-query
//      tile and streams 64-key K/V tiles straight out of the slab at column
//      offsets h*64, D+h*64 and 2D+h*64 (no head transposes). The ragged tail
//      (T=257 = 4*64+1) is masked, not padded. Exact online softmax with the
//      running row max: f32 scores and softmax, P rounded to bf16 for the P.V
//      mma with f32 accumulation, divided by the f32 row sum at the end.
//      Output bf16 into an attention slab (B, T, D) in HBM. The core is
//      attention_core.cuh::attention_tile, which K4 (flash_attention.cu)
//      runs too.
//   3. gemm_kernel (residual epilogue): attn @ w_proj, epilogue
//      bf16(acc) + bf16(b_proj), * bf16(ls1), + x, each step rounded to bf16.
// The TPU kernel keeps the qkv slab and the attention output on chip; this
// version writes and re-reads both (76 MB of qkv and 25 MB of attention per
// call at the main-path shape). Keeping them on chip, wgmma and TMA, and
// pipelined tile loads are left for later work.
//
// Numerics follow the JAX package's cast points (fused_attention.py:600-626):
// f32 LN statistics, LN affine in f32 then one bf16 cast; f32-accumulated
// GEMMs cast to bf16 before the bias add; f32 scores and softmax; bf16 P.V
// with f32 accumulation. The 1/sqrt(64) = 1/8 scale multiplies the f32
// scores (exact: a power of two); the log2(e) fold into bf16 q that the TPU
// kernel makes is not copied.
//
// Shared memory is static (< 48 KB per block), so no opt-in attribute is
// needed. Every entry point returns cudaGetLastError() after its launches.

#include "half_layer.cuh"

extern "C" {

// The whole half-layer, three launches on `stream`. qkv_scratch (B, T, 3D)
// and attn_scratch (B, T, D) are bf16 buffers the caller allocated; out is
// (B, T, D). Requires D == 64 * heads, 16-byte aligned pointers, and the
// tensors' device current on the calling thread (the caller sets it).
int dinov2_slab_layer_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                           const void* w_qkv, const void* b_qkv, const void* w_proj,
                           const void* b_proj, const void* ls1, void* qkv_scratch,
                           void* attn_scratch, void* out, int b, int t, int d, int heads,
                           float scale, float eps, void* stream) {
  using namespace dinov2;
  const int n_qkv = 3 * d;
  return launch_half_layer(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), DenseWeightTile{static_cast<const bf16*>(w_qkv), n_qkv},
      static_cast<const float*>(b_qkv), DenseWeightTile{static_cast<const bf16*>(w_proj), d},
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
      static_cast<bf16*>(qkv_scratch), static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out),
      b, t, d, heads, scale, eps, static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
