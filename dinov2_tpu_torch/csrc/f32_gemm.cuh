// The f32 half of K1's, K2's, K5's and K8's GEMM launches, and their f32
// layer norm:
//
//     h (M, K)   = LN(x)                            f32_row_norm_kernel
//     out (M, N) = ep(A @ W)                        f32_ffma_gemm_kernel
//
// for f32 A (M, K) row-major and W (K, N) row-major, the (in, out) layout of
// the dense weights (K8 dequantizes into it); with F32Bias (acc + b_qkv),
// F32Residual (x + (acc + b_proj) * ls1, K5's fc2 likewise with b2 and ls2)
// or F32Act (act(acc + b1), K5's fc1). K % 16 == 0, N % 4 == 0, any M >= 1.
//
// The TPU kernels behind them (dinov2_tpu/ops/fused_attention.py::
// _slab_layer_kernel, _slab_proj_kernel, _slab_mlp_kernel,
// _slab_mlp_flat_kernel; fused_quant_attention.py::_quant_layer_kernel)
// are generic in dtype: with f32 activations every "cast to the compute
// dtype" is a no-op, the products accumulate in f32 and the bias,
// LayerScale, activation and residual are applied in f32.
// Those numerics need the products in full f32: one-pass TF32 on the tensor
// cores keeps 10 mantissa bits (about 1e-3 relative), far outside the f32
// envelope the port is held to (docs/PARITY.md). So this is a CUDA-core FFMA
// GEMM; a 3xTF32 wgmma version is later work (ROADMAP.md).
//
// What bounds it on an H100: at K1's shape (M = 64*257 = 16448, K = 768) the
// QKV product is 58.2 GFLOP over 50.5 MB in, 151.6 MB out and 7.1 MB of
// weight; at the 67 TFLOP/s of f32 outside the tensor cores that is 0.87 ms
// against 0.06 ms for the bytes at 3.35 TB/s: operations bind it, and proj
// (19.4 GFLOP, 0.29 ms) likewise.
//
// Design: the classic SIMT tiling. A block of 256 threads owns a 128 x 128
// output tile (grid (ceil(N / 128), ceil(M / 128)), the column tiles of a
// row tile side by side so they find the A rows in L2); a thread owns 8 x 8
// of it, rows {4*ty .. 4*ty+3, 64+4*ty ..} and columns {4*tx .., 64+4*tx ..}
// (tx, ty = thread % 16, thread / 16), so that its operand reads are two
// 16-byte loads each and a quarter-warp's loads hit 32 distinct banks.
// 16-deep k-steps go through a two-stage ring filled by cp.async, one step
// ahead of the arithmetic: the A tile is stored transposed (k rows of 128
// m, padded by 4 floats), each float copied by a 4-byte cp.async; the W tile
// is copied as it lies, 16 bytes a thread. Per k-step a thread reads 4 x 16
// bytes and does 64 FFMA. Rows past M and columns past N are zero-filled in
// shared memory and not written.
//
// Layer norm is a kernel of its own in front of the QKV product, as in the
// bf16 K1: a warp a row, f32 statistics in two passes, (x - mu) * rstd *
// scale + bias without fused multiply-add, written once to an (M, K) f32
// buffer the caller gives.

#pragma once

#include "activation.cuh"
#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kF32GemmTile = 128;   // rows and columns of a block's output tile
constexpr int kF32GemmDepth = 16;   // k a ring stage holds
constexpr int kF32GemmThreads = 256;
constexpr int kF32ALd = kF32GemmTile + 4;  // row stride of the transposed A tile, floats
constexpr int kF32GemmStageFloats = kF32GemmDepth * (kF32ALd + kF32GemmTile);
constexpr int kF32LayerNormThreads = 256;  // eight rows a block

// out (M, N) = acc + bias
struct F32Bias {
  const float* bias;
  float* out;
  int n;

  __device__ __forceinline__ void store4(int row, int c, float4 acc) const {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * n + c) =
        make_float4(__fadd_rn(acc.x, b.x), __fadd_rn(acc.y, b.y), __fadd_rn(acc.z, b.z),
                    __fadd_rn(acc.w, b.w));
  }
};

// out = resid + (acc + bias) * ls, in that order, each step rounded once
// (no fused multiply-add: the plain version's three operations)
struct F32Residual {
  const float* bias;
  const float* ls;
  const float* resid;
  float* out;
  int n;

  __device__ __forceinline__ static float step(float a, float b, float l, float x) {
    return __fadd_rn(x, __fmul_rn(__fadd_rn(a, b), l));
  }

  __device__ __forceinline__ void store4(int row, int c, float4 acc) const {
    const size_t at = static_cast<size_t>(row) * n + c;
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
    const float4 l = __ldg(reinterpret_cast<const float4*>(ls + c));
    const float4 x = *reinterpret_cast<const float4*>(resid + at);
    *reinterpret_cast<float4*>(out + at) =
        make_float4(step(acc.x, b.x, l.x, x.x), step(acc.y, b.y, l.y, x.y),
                    step(acc.z, b.z, l.z, x.z), step(acc.w, b.w, l.w, x.w));
  }
};

// out (M, N) = act(acc + bias): K5's fc1 in the JAX order (a1 + b1, then
// apply_activation, fused_attention.py:876-877), the bias add rounded once
// before the activation; activation.cuh's formulas, gelu_tanh_f16 through
// f16 on both sides (round to nearest even, +-inf past 65504, no clamp)
template <int kAct>
struct F32Act {
  const float* bias;
  float* out;
  int n;

  __device__ __forceinline__ static float step(float a, float b) {
    return activate(__fadd_rn(a, b), kAct);
  }

  __device__ __forceinline__ void store4(int row, int c, float4 acc) const {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c));
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * n + c) =
        make_float4(step(acc.x, b.x), step(acc.y, b.y), step(acc.z, b.z), step(acc.w, b.w));
  }
};

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

// One block's 128 x 128 output tile of ep(A @ W); see the note above.
template <class Epilogue>
__global__ void __launch_bounds__(kF32GemmThreads, 2)
    f32_ffma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ w, Epilogue ep,
                         int m, int n, int k) {
  __shared__ __align__(16) float ring[2 * kF32GemmStageFloats];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kF32GemmTile, col0 = blockIdx.x * kF32GemmTile;

  // stage s <- k-step `step`: A^T (16 x 128, stride kF32ALd), then W (16 x 128)
  auto load_stage = [&](int s, int step) {
    const int k0 = step * kF32GemmDepth;
    float* a_s = ring + s * kF32GemmStageFloats;
    float* w_s = a_s + kF32GemmDepth * kF32ALd;
    const int c = tid & 15;  // A: 16 threads a row, one float each
#pragma unroll
    for (int i = 0; i < kF32GemmTile / 16; ++i) {
      const int r = (tid >> 4) + 16 * i;
      const bool valid = row0 + r < m;
      const float* src = a + static_cast<size_t>(valid ? row0 + r : 0) * k + k0 + c;
      cp_async_4(shared_address(a_s + c * kF32ALd + r), src, valid);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 32 threads a k row, 16 bytes each
      const int kr = (tid >> 5) + 8 * i, cc = (tid & 31) * 4;
      const bool valid = col0 + cc < n;
      const float* src = w + static_cast<size_t>(k0 + kr) * n + (valid ? col0 + cc : 0);
      cp_async_16(shared_address(w_s + kr * kF32GemmTile + cc), src, valid);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int steps = k / kF32GemmDepth;
  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of `step` has landed
    __syncthreads();     // everyone's has
    const float* a_s = ring + (step & 1) * kF32GemmStageFloats;
    const float* w_s = a_s + kF32GemmDepth * kF32ALd;
#pragma unroll
    for (int kk = 0; kk < kF32GemmDepth; ++kk) {
      float av[8], wv[8];
      *reinterpret_cast<float4*>(av) =
          *reinterpret_cast<const float4*>(a_s + kk * kF32ALd + 4 * ty);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(a_s + kk * kF32ALd + 64 + 4 * ty);
      *reinterpret_cast<float4*>(wv) =
          *reinterpret_cast<const float4*>(w_s + kk * kF32GemmTile + 4 * tx);
      *reinterpret_cast<float4*>(wv + 4) =
          *reinterpret_cast<const float4*>(w_s + kk * kF32GemmTile + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + 64 * half + 4 * tx;
      if (c < n) {
        ep.store4(row, c, make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                                      acc[i][4 * half + 2], acc[i][4 * half + 3]));
      }
    }
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

// ep(A @ W) on stream s, W (K, N).
template <class Epilogue>
cudaError_t launch_f32_gemm(const float* a, const float* w, Epilogue ep, int m, int n, int k,
                            cudaStream_t s) {
  f32_ffma_gemm_kernel<Epilogue>
      <<<dim3((n + kF32GemmTile - 1) / kF32GemmTile, (m + kF32GemmTile - 1) / kF32GemmTile),
         kF32GemmThreads, 0, s>>>(a, w, ep, m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2
