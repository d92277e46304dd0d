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
// _quant_layer_kernel, reached through slab_layer_block_quant.
//
// It is the half-layer's three launches (half_layer.cuh) with gemm_core.cuh's
// mma.sync GEMM and the quant weight loader (dequant_tile.cuh) in launches 1
// and 3: each 64x64 weight tile is dequantized from the ggml blocks as it is
// staged into shared memory, in dequant_weight's order (code -> f32, * d,
// + m, one bf16 cast), so the kernel computes K1's function on
// dequant_weight(W, bf16) and the dense weight never exists in HBM. Launch 2
// is K1's and K3's attention kernel (launch_slab_attention) and is all the
// code K8 shares with K1: K1's GEMMs run on wgmma_gemm.cuh, so K8 is held to
// K1 on dequantized weights within one bf16 step of the output's scale (on
// an H100 the two gave equal bits wherever they were compared). The TPU kernel instead dequantizes both weights once per
// call into VMEM scratch; a block here dequantizes its tiles once per row
// tile, which re-reads the packed weight (0.56-1.06 B per weight against
// bf16's 2) from L2 many times but keeps the blocks independent.
//
// What bounds it on an H100: the two GEMMs (unpipelined mma.sync, ~78 of the
// ~91 GFLOP per call at B=64, T=257, D=768, H=12), plus the dequant work, ~4 integer and
// 2 f32 operations per weight element per 64-row tile. The weights are
// 1.3-2.5 MB against K1's 4.7 MB; the qkv slab (76 MB) and the attention
// output (25 MB) go through HBM as in K1.

#include "dequant_tile.cuh"
#include "half_layer.cuh"

namespace {

using namespace dinov2;

// The three launches on stream s; w_qkv and w_proj are the weight loaders for
// (D -> 3D) and (D -> D). qkv (B, T, 3D) and attn (B, T, D) are scratch the
// caller allocated. Returns the first launch error.
cudaError_t launch_quant_layer(const bf16* x, const float* ln_scale, const float* ln_bias,
                               QuantWeightTile w_qkv, const float* b_qkv, QuantWeightTile w_proj,
                               const float* b_proj, const float* ls1, bf16* qkv, bf16* attn,
                               bf16* out, int b, int t, int d, int heads, float scale, float eps,
                               cudaStream_t s) {
  const int m = b * t;
  const int row_tiles = (m + kTile - 1) / kTile;

  gemm_ln_kernel<QuantWeightTile, BiasEpilogue>
      <<<dim3(3 * d / kTile, row_tiles), kThreads, 0, s>>>(
          x, w_qkv, ln_scale, ln_bias, eps, BiasEpilogue{b_qkv, qkv, 3 * d}, m, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_slab_attention(qkv, attn, b, t, d, heads, scale, s);
  if (err != cudaSuccess) return err;

  gemm_kernel<QuantWeightTile, ResidualEpilogue><<<dim3(d / kTile, row_tiles), kThreads, 0, s>>>(
      attn, w_proj, ResidualEpilogue{b_proj, ls1, x, out, d}, m, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole half-layer, three launches on `stream`. Each weight comes as
// codes, d, m (null for q4_0/q5_0/q8_0), qh_lo and qh_hi (null but for
// packed q5), its layout (packed) and zero point; qkv is (3D, D), proj
// (D, D). qkv_scratch (B, T, 3D) and attn_scratch (B, T, D) are bf16
// buffers the caller allocated; out is (B, T, D). Requires D == 64 * heads,
// D/2 % 64 == 0 for packed weights, 16-byte aligned pointers, and the
// tensors' device current on the calling thread.
int dinov2_quant_layer_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                            const void* qkv_codes, const void* qkv_d, const void* qkv_m,
                            const void* qkv_qh_lo, const void* qkv_qh_hi, int qkv_packed,
                            int qkv_zero, const void* b_qkv, const void* proj_codes,
                            const void* proj_d, const void* proj_m, const void* proj_qh_lo,
                            const void* proj_qh_hi, int proj_packed, int proj_zero,
                            const void* b_proj, const void* ls1, void* qkv_scratch,
                            void* attn_scratch, void* out, int b, int t, int d, int heads,
                            float scale, float eps, void* stream) {
  return launch_quant_layer(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias),
      QuantWeightTile{
          quant_weight(qkv_codes, qkv_d, qkv_m, qkv_qh_lo, qkv_qh_hi, qkv_packed, qkv_zero, 3 * d,
                       d)},
      static_cast<const float*>(b_qkv),
      QuantWeightTile{quant_weight(proj_codes, proj_d, proj_m, proj_qh_lo, proj_qh_hi,
                                   proj_packed, proj_zero, d, d)},
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
      static_cast<bf16*>(qkv_scratch), static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out),
      b, t, d, heads, scale, eps, static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
