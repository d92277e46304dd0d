// The f32 half of K1's, K2's, K5's and K8's launches: their f32 layer norm,
// and their GEMMs on the 3xTF32 core they share with K7 f32:
//
//     h (M, K)   = LN(x)                            f32_row_norm_kernel
//     out (M, N) = ep(A @ W)                        launch_f32_linear
//
// for f32 A (M, K) row-major and W (K, N) row-major, the (in, out) layout of
// the dense weights; with F32Bias (acc + b_qkv), F32Residual (x + (acc +
// b_proj) * ls1, K5's fc2 likewise with b2 and ls2) or F32Act (act(acc +
// b1), K5's fc1). launch_f32_linear (tf32x3_gemm.cuh) is two launches: W's
// two TF32 planes, split and transposed into the K-major (2, N, K) layout
// .tf32 wgmma reads, into a scratch the caller gives (split_tf32_t_kernel),
// then the persistent 3xTF32 GEMM on them (tf32x3_gemm_kernel). K8 f32
// dequantizes its weights straight into such planes and runs the same GEMM.
// K % 4 == 0, any M >= 1 and N; a K that is not a multiple of the GEMM's
// 32-deep k-step ends in a step the TMA fills with zeros.
//
// The TPU kernels behind them (dinov2_tpu/ops/fused_attention.py::
// _slab_layer_kernel, _slab_proj_kernel, _slab_mlp_kernel,
// _slab_mlp_flat_kernel; fused_quant_attention.py::_quant_layer_kernel)
// are generic in dtype: with f32 activations every "cast to the compute
// dtype" is a no-op, the products accumulate in f32 and the bias,
// LayerScale, activation and residual are applied in f32.
// Those numerics need f32-accurate products: one-pass TF32 on the tensor
// cores keeps 10 mantissa bits (about 1e-3 relative), far outside the f32
// envelope the port is held to (docs/PARITY.md); 3xTF32 (tf32x3.cuh) keeps
// them within it.
//
// What bounds them on an H100: at K1's shape (M = 64*257 = 16448, K = 768)
// the QKV product is 58.2 GFLOP over 50.5 MB in, 151.6 MB out and 7.1 MB of
// weight; at 3xTF32's 165 TFLOP/s that is 0.35 ms against 0.06 ms for the
// bytes at 3.35 TB/s: operations bind it, and proj (19.4 GFLOP, 0.12 ms)
// likewise. The weight's split reads 7.1 MB and writes 14.2 MB (~6 us of
// HBM time).
//
// Layer norm is a kernel of its own in front of the QKV product, as in the
// bf16 K1: a warp a row, f32 statistics in two passes, (x - mu) * rstd *
// scale + bias without fused multiply-add, written once to an (M, K) f32
// buffer the caller gives.

#pragma once

#include "activation.cuh"
#include "tf32x3_gemm.cuh"

namespace dinov2 {
namespace {

constexpr int kF32LayerNormThreads = 256;  // eight rows a block

// h[row] = LN(x[row]) for x, h (M, K) f32, K % 4 == 0, one warp a row.
__global__ void __launch_bounds__(kF32LayerNormThreads)
    f32_row_norm_kernel(const float* __restrict__ x, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, float* __restrict__ h, int m, int k,
                        float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kF32LayerNormThreads / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const float* src = x + static_cast<size_t>(row) * k;
  float s = 0.f;
  for (int c = lane * 4; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / static_cast<float>(k);
  float var = 0.f;
  for (int c = lane * 4; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    var += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rstd = 1.f / sqrtf(warp_sum(var) / static_cast<float>(k) + eps);
  float* dst = h + static_cast<size_t>(row) * k;
  for (int c = lane * 4; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    const float4 sc = __ldg(reinterpret_cast<const float4*>(ln_scale + c));
    const float4 bi = __ldg(reinterpret_cast<const float4*>(ln_bias + c));
    const float e[4] = {v.x, v.y, v.z, v.w}, g[4] = {sc.x, sc.y, sc.z, sc.w},
                b[4] = {bi.x, bi.y, bi.z, bi.w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[q] = __fadd_rn(__fmul_rn(__fmul_rn(e[q] - mu, rstd), g[q]), b[q]);
    }
    *reinterpret_cast<float4*>(dst + c) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// h (M, K) = LN(x) on stream s.
inline cudaError_t launch_f32_layer_norm_rows(const float* x, const float* ln_scale,
                                              const float* ln_bias, float* h, int m, int k,
                                              float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kF32LayerNormThreads / 32;
  f32_row_norm_kernel<<<(m + kRowsPerBlock - 1) / kRowsPerBlock, kF32LayerNormThreads, 0, s>>>(
      x, ln_scale, ln_bias, h, m, k, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2
