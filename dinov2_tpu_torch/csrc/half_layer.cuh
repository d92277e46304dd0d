// The attention launch of the attention half-layer,
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
// shared by K1 (slab_layer.cu, dense bf16 weights), K2 and K3
// (slab_attention.cu) and K8 (quant_layer.cu, ggml-quantized weights). Each
// half-layer is three launches with the (B, T, 3D) qkv slab and the (B, T, D)
// attention output in HBM between them:
//   1. LN1 and the QKV GEMM, epilogue bf16(acc) + bf16(b_qkv) -> qkv slab;
//   2. launch_slab_attention below -> attention output;
//   3. the proj GEMM with the bias/LayerScale/residual epilogue.
// Launch 2 is all that K8 shares with K1: K1 and K2 run their GEMMs on
// wgmma_gemm.cuh (wgmma from pipelined swizzled tiles), K8 on gemm_core.cuh
// (mma.sync, with dequant_tile.cuh's loader). Both add the k16 products into
// f32 in k order and gave equal bits on an H100 wherever they were compared,
// but nothing promises it: K8 is held to K1 within one bf16 step.

#pragma once

#include "flash_forward.cuh"

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

}  // namespace
}  // namespace dinov2
