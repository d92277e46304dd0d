// The attention half-layer's three launches, shared by K1 (slab_layer.cu,
// dense bf16 weights) and K8 (quant_layer.cu, ggml-quantized weights):
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
//   1. gemm_ln_kernel: LN1 statistics and affine in f32, then the QKV GEMM;
//      epilogue bf16(acc) + bf16(b_qkv) -> qkv slab (B, T, 3D) in HBM;
//   2. slab_attention_kernel: attention_core.cuh::attention_tile per
//      (image, head, 64-query tile), reading q/k/v straight out of the slab
//      at column offsets h*64, D+h*64 and 2D+h*64 -> (B, T, D) in HBM;
//   3. gemm_kernel: the proj GEMM with the bias/LayerScale/residual epilogue.
// The two kernels differ only in the GEMMs' weight loader (gemm_core.cuh).

#pragma once

#include "gemm_core.cuh"

namespace dinov2 {

// out[b, t, h*64:(h+1)*64] = softmax(q k^T * scale) v for one (image, head)
// pair and a tile of 64 queries, read straight out of the (B, T, 3D) slab.
__global__ void __launch_bounds__(kThreads, kAttentionBlocksPerSm)
    slab_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int t, int d,
                          int heads, float scale) {
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const size_t ld = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(img) * t * ld + head * kHeadDim;
  attention_tile(base, base + d, base + 2 * d, ld,
                 out + static_cast<size_t>(img) * t * d + head * kHeadDim, d, t,
                 blockIdx.y * kTile, scale);
}

// The three launches on stream s; w_qkv and w_proj are gemm_core.cuh weight
// loaders for (D -> 3D) and (D -> D). qkv (B, T, 3D) and attn (B, T, D) are
// scratch the caller allocated. Returns the first launch error.
template <class QkvWeight, class ProjWeight>
cudaError_t launch_half_layer(const bf16* x, const float* ln_scale, const float* ln_bias,
                              QkvWeight w_qkv, const float* b_qkv, ProjWeight w_proj,
                              const float* b_proj, const float* ls1, bf16* qkv, bf16* attn,
                              bf16* out, int b, int t, int d, int heads, float scale, float eps,
                              cudaStream_t s) {
  const int m = b * t;
  const int row_tiles = (m + kTile - 1) / kTile;

  gemm_ln_kernel<QkvWeight, BiasEpilogue><<<dim3(3 * d / kTile, row_tiles), kThreads, 0, s>>>(
      x, w_qkv, ln_scale, ln_bias, eps, BiasEpilogue{b_qkv, qkv, 3 * d}, m, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  slab_attention_kernel<<<dim3(b * heads, (t + kTile - 1) / kTile), kThreads, 0, s>>>(
      qkv, attn, t, d, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gemm_kernel<ProjWeight, ResidualEpilogue><<<dim3(d / kTile, row_tiles), kThreads, 0, s>>>(
      attn, w_proj, ResidualEpilogue{b_proj, ls1, x, out, d}, m, d);
  return cudaGetLastError();
}

}  // namespace dinov2
