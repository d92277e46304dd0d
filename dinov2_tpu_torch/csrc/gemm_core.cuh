// The port's mma.sync bf16 GEMM core: one 64x64 output tile per block, four
// warps, mma.sync m16n8k16 (bf16 in, f32 accumulate), 64-deep k-steps staged
// in shared memory. K8 (quant_layer.cu) runs it; how a weight tile reaches
// shared memory and the epilogue are template parameters. The GEMMs of K1,
// K2, K5 and K7 run on wgmma_gemm.cuh and take only the epilogues from here
// (BiasEpilogue: K1's QKV; ResidualEpilogue: K1's and K2's proj, K5's fc2;
// ActEpilogue: K5's fc1, K7):
//
//   Weight: the tile sits in shared memory as ws[n][k]; store8(ws, r, c, k0,
//     col0) writes the 8 values at tile row r, columns c..c+7 (c % 8 == 0)
//     for the k-step at k0 of the block at output column col0.
//       QuantWeightTile (dequant_tile.cuh): a ggml QuantLinear (N, K)
//       dequantized on the way in.
//   Epilogue: col = ep.column(c) reads what the output columns c and c + 1
//     (c even) share across rows (their bias), once per warp tile; then
//     ep(row, c, col, acc_c, acc_c1) for each row < M. It masks columns >= N
//     itself.
//
// The tile loads are not pipelined (no cp.async, TMA or wgmma yet): this is
// the port's simple first GEMM.

#pragma once

#include "activation.cuh"
#include "attention_core.cuh"

namespace dinov2 {

// minimum resident blocks per SM for gemm_kernel (no LN): caps it at 64
// registers a thread, so eight 128-thread blocks share an SM. Without it the
// residual epilogue's instantiation took 72 registers (seven blocks) and
// the half-layer's proj launch ran 8% slower. gemm_ln_kernel keeps the
// compiler's own choice (56 registers): under this cap it took 64 and ran
// 1.5% slower, and with an explicit minimum of 1 block it took 86 and ran 9%
// slower.
constexpr int kGemmBlocksPerSm = 8;

// bf16(bias) of the columns c and c + 1
struct BiasPair {
  float b0, b1;
};

// out (M, N) = bf16(acc) + bf16(bias), N a multiple of 64.
struct BiasEpilogue {
  const float* bias;
  bf16* out;
  int n;

  __device__ __forceinline__ BiasPair column(int c) const {
    return {round_bf16(bias[c]), round_bf16(bias[c + 1])};
  }

  __device__ __forceinline__ void operator()(int row, int c, const BiasPair& col, float a0,
                                             float a1) const {
    const float y0 = round_bf16(round_bf16(a0) + col.b0);
    const float y1 = round_bf16(round_bf16(a1) + col.b1);
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * n + c) = pack_floats(y0, y1);
  }

  // The same in two steps, for a kernel that gathers whole 16-byte pieces of
  // a row before it writes (wgmma_gemm.cuh): the finished pair of columns c
  // and c + 1, then eight finished values at row `row`, columns c..c + 7
  // (c % 8 == 0).
  __device__ __forceinline__ uint32_t pair(int, const BiasPair& col, float a0, float a1) const {
    return pack_floats(round_bf16(a0) + col.b0, round_bf16(a1) + col.b1);
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n + c) = v;
  }
};

// out = resid + bf16(y * bf16(ls)) with y = bf16(acc) + bf16(bias), each
// step rounded to bf16; N a multiple of 64.
struct ResidualEpilogue {
  const float* bias;
  const float* ls;
  const bf16* resid;
  bf16* out;
  int n;

  __device__ __forceinline__ BiasPair column(int c) const {
    return {round_bf16(bias[c]), round_bf16(bias[c + 1])};
  }

  __device__ __forceinline__ void operator()(int row, int c, const BiasPair& col, float a0,
                                             float a1) const {
    const size_t at = static_cast<size_t>(row) * n + c;
    float y0 = round_bf16(round_bf16(a0) + col.b0);
    float y1 = round_bf16(round_bf16(a1) + col.b1);
    y0 = __bfloat162float(resid[at]) + round_bf16(y0 * round_bf16(ls[c]));
    y1 = __bfloat162float(resid[at + 1]) + round_bf16(y1 * round_bf16(ls[c + 1]));
    *reinterpret_cast<uint32_t*>(out + at) = pack_floats(y0, y1);
  }

  // The same in two steps (see BiasEpilogue): bf16(y * bf16(ls)) of the
  // columns c and c + 1, then the residual added to eight of them.
  __device__ __forceinline__ uint32_t pair(int c, const BiasPair& col, float a0, float a1) const {
    const float y0 = round_bf16(round_bf16(a0) + col.b0);
    const float y1 = round_bf16(round_bf16(a1) + col.b1);
    return pack_floats(y0 * round_bf16(ls[c]), y1 * round_bf16(ls[c + 1]));
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    const size_t at = static_cast<size_t>(row) * n + c;
    const uint4 x = *reinterpret_cast<const uint4*>(resid + at);
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ve = reinterpret_cast<const bf16*>(&v);
    uint4 y;
    uint32_t* ye = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ye[i] = pack_floats(__bfloat162float(xe[2 * i]) + __bfloat162float(ve[2 * i]),
                          __bfloat162float(xe[2 * i + 1]) + __bfloat162float(ve[2 * i + 1]));
    }
    *reinterpret_cast<uint4*>(out + at) = y;
  }
};

// out (M, N) = act(bf16(acc) + bf16(bias)), the activation kAct
// (activation.cuh) in f32 on the bf16 value and rounded once more; bias may
// be null (no add). Any N >= 1: the columns past N are computed and not
// written, and a row of a width N % 8 != 0 is not 16-byte aligned, so it is
// written value by value. For wgmma_gemm.cuh only (pair / store8). The
// activation is a template parameter, and the C entries switch on the
// runtime code once per launch: the activation's code as a runtime switch
// inside the epilogue's loop over 64 accumulator values made K5 14% and K7
// at fc1 20% slower than with it fixed at compile time, on an H100
// (scripts/compare_kernel_builds.py against a copy so changed).
template <int kAct>
struct ActEpilogue {
  const float* bias;
  bf16* out;
  int n;

  // bf16(bias) of the columns c and c + 1 that exist, else 0 (no bias add)
  __device__ __forceinline__ BiasPair column(int c) const {
    BiasPair col{0.f, 0.f};
    if (bias && c < n) col.b0 = round_bf16(bias[c]);
    if (bias && c + 1 < n) col.b1 = round_bf16(bias[c + 1]);
    return col;
  }

  __device__ __forceinline__ uint32_t pair(int, const BiasPair& col, float a0, float a1) const {
    float y0 = round_bf16(a0), y1 = round_bf16(a1);
    if (bias) {
      y0 = round_bf16(y0 + col.b0);
      y1 = round_bf16(y1 + col.b1);
    }
    return pack_floats(activate(y0, kAct), activate(y1, kAct));
  }

  __device__ __forceinline__ void store8(int row, int c, uint4 v) const {
    bf16* dst = out + static_cast<size_t>(row) * n + c;
    if ((n & 7) == 0) {
      if (c < n) *reinterpret_cast<uint4*>(dst) = v;
      return;
    }
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c + i < n) dst[i] = e[i];
    }
  }
};

// One block's 64x64 output tile of ep(A' @ W), A (M, K) row-major bf16,
// A' = LN(A) when kLayerNorm, K a multiple of 64. Warp w owns rows
// 32*(w/2).. and columns 32*(w%2).. of the tile. The kernels below run it.
template <bool kLayerNorm, class Weight, class Epilogue>
__device__ __forceinline__ void gemm_tile(const bf16* __restrict__ a, const Weight& w,
                                          const float* __restrict__ ln_scale,
                                          const float* __restrict__ ln_bias, float eps,
                                          const Epilogue& ep, int m, int k) {
  __shared__ __align__(16) bf16 as[kTile][kLds];
  __shared__ __align__(16) bf16 ws[kTile][kLds];
  __shared__ float row_mu[kTile];
  __shared__ float row_rstd[kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  if (kLayerNorm) {
    // two-pass f32 statistics of the tile's rows, one warp per row
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const int row = row0 + r;
      float mu = 0.f, rstd = 0.f;
      if (row < m) {
        const bf16* src = a + static_cast<size_t>(row) * k;
        float s = 0.f;
        for (int c = lane; c < k; c += 32) s += __bfloat162float(src[c]);
        mu = warp_sum(s) / static_cast<float>(k);
        float v = 0.f;
        for (int c = lane; c < k; c += 32) {
          const float dlt = __bfloat162float(src[c]) - mu;
          v += dlt * dlt;
        }
        rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(k) + eps);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTile) {
    // stage one 64x64 tile of A' and of W, 8 values (16 bytes) per piece
    for (int i = tid; i < kTile * kTile / 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int row = row0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      if (row < m) {
        va = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * k + k0 + c);
        if (kLayerNorm) {
          bf16* e = reinterpret_cast<bf16*>(&va);
          const float mu = row_mu[r], rstd = row_rstd[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // (x - mu) * rstd * scale + bias in f32, no fused multiply-add,
            // then one bf16 cast
            const float h = __fmul_rn(__bfloat162float(e[j]) - mu, rstd);
            e[j] = __float2bfloat16(
                __fadd_rn(__fmul_rn(h, ln_scale[k0 + c + j]), ln_bias[k0 + c + j]));
          }
        }
      }
      *reinterpret_cast<uint4*>(&as[r][c]) = va;
      w.store8(ws, r, c, k0, col0);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + g;
        af[mi][0] = ld_pair(&as[r][kk + 2 * tig]);
        af[mi][1] = ld_pair(&as[r + 8][kk + 2 * tig]);
        af[mi][2] = ld_pair(&as[r][kk + 8 + 2 * tig]);
        af[mi][3] = ld_pair(&as[r + 8][kk + 8 + 2 * tig]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = warp_n * 32 + ni * 8 + g;
        const uint32_t b0 = ld_pair(&ws[c][kk + 2 * tig]);
        const uint32_t b1 = ld_pair(&ws[c][kk + 8 + 2 * tig]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = col0 + warp_n * 32 + ni * 8 + 2 * tig;
      const auto col = ep.column(c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + warp_m * 32 + mi * 16 + g + 8 * half;
        if (row < m) ep(row, c, col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// ep(A @ W); grid (ceil(N/64), ceil(M/64)).
template <class Weight, class Epilogue>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    gemm_kernel(const bf16* __restrict__ a, Weight w, Epilogue ep, int m, int k) {
  gemm_tile<false>(a, w, nullptr, nullptr, 0.f, ep, m, k);
}

// ep(LN(A) @ W): f32 LN statistics of each row, LN affine in f32, one bf16
// cast; grid (ceil(N/64), ceil(M/64)).
template <class Weight, class Epilogue>
__global__ void __launch_bounds__(kThreads)
    gemm_ln_kernel(const bf16* __restrict__ a, Weight w, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, float eps, Epilogue ep, int m, int k) {
  gemm_tile<true>(a, w, ln_scale, ln_bias, eps, ep, m, k);
}

}  // namespace dinov2
