// K6's f32 variant: the flash attention backward in full f32,
//
//     p  = exp(scale * q k^T - lse)                 (recomputed, never stored)
//     dS = p * (dO v^T - delta) * scale,  delta = rowsum(dO * O)
//     dV = p^T dO      dK = dS^T q      dQ = dS k
//
// per (image, head), for f32 q, k, v of head_dim 64 read through three base
// pointers that share a batch, a token and a head stride (multiples of 4
// elements), contiguous (B, T, H, 64) f32 O and dO, and the (B, H, T) f32 lse
// of the training forward (f32_attention.cuh, kWithLse); dq, dk and dv
// written through three pointers and shared strides, as the bf16 K6.
//
// Replaces, for f32 activations, the Pallas TPU kernels
// dinov2_tpu/ops/flash_attention.py::_dkv_kernel and _dq_kernel (with their
// shared _bwd_p_ds), which multiply p and dS as f32: here nothing is rounded
// between the steps, and the products run as FFMA on the CUDA cores (full
// f32; f32_gemm.cuh's note).
//
// What bounds it on an H100: the least work is five T x T x 64 products,
// 10*B*H*T^2*64 FLOP: 154 GFLOP at B=8, T=1370, H=16 (2.29 ms at 67 TFLOP/s
// f32) and 16.2 GFLOP at B=32, T=257, H=12 (0.24 ms): operations bind both
// (the eight (B, T, H, 64) f32 tensors in HBM, 359 MB and 202 MB, take 0.11
// and 0.06 ms at 3.35 TB/s).
//
// Design, as the bf16 K6: two kernels keep the result deterministic with no
// atomics, dK/dV with one block per (image, head, 64-key tile) looping over
// the query tiles in order, dQ with one block per (image, head, 64-query
// tile) looping over the key tiles in order; both recompute s and dO v^T
// (seven products for the five), and a delta prologue (16 threads a row)
// reads O and dO once. A block is 256 threads on f32_attention.cuh's padded
// tiles and thread layout: the dK/dV kernel keeps K and V, streams Q, dO,
// lse and delta through a two-stage cp.async ring, computes s^T = K Q^T and
// dP^T = V dO^T with a thread on keys 4*ty.. and queries tx, tx + 16, ..,
// writes p^T and dS^T to two shared tiles, and then accumulates dV += p^T dO
// and dK += dS^T q on dims 4*tx.. of its keys (32 accumulators a thread).
// The dQ kernel keeps Q and dO (lse and delta of its rows in registers),
// streams K and V, writes dS to one shared tile and accumulates dQ += dS k.
// The ragged tail is masked: rows past T are zero-filled in shared memory,
// p is forced to 0 where the key or the query lies past T, and rows past T
// are not written.
//
// Shared memory is dynamic: eight 17 KB tiles and the ring's row statistics
// for the dK/dV kernel (137 KB: one block an SM), seven for the dQ kernel
// (119 KB).

#pragma once

#include "f32_attention.cuh"

namespace dinov2 {
namespace {

constexpr int kF32StatsFloats = 2 * kTile;  // lse and delta of a query tile
constexpr int kF32DkvShared = (8 * kF32TileFloats + 2 * kF32StatsFloats) * 4;
constexpr int kF32DqShared = 7 * kF32TileFloats * 4;
constexpr int kF32DeltaRows = kF32AttentionThreads / 16;

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; o and d_out
// contiguous (B, T, H, 64) f32. Sixteen threads a row, 16 bytes of each
// tensor a thread: bytes bind it.
__global__ void __launch_bounds__(kF32AttentionThreads)
    f32_backward_delta_rows(const float* __restrict__ o, const float* __restrict__ d_out,
                            float* __restrict__ delta, int rows, int t, int heads) {
  const int row = blockIdx.x * kF32DeltaRows + (threadIdx.x >> 4);
  const bool valid = row < rows;
  const size_t at = static_cast<size_t>(valid ? row : 0) * kHeadDim + (threadIdx.x & 15) * 4;
  const float4 a = *reinterpret_cast<const float4*>(o + at);
  const float4 b = *reinterpret_cast<const float4*>(d_out + at);
  float sum = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
  sum = row_sum16(sum);
  if (valid && (threadIdx.x & 15) == 0) {
    const int head = row % heads, token = (row / heads) % t, img = row / (heads * t);
    delta[(static_cast<size_t>(img) * heads + head) * t + token] = sum;
  }
}

// This thread's 4 x 4 share of a 64 x 64 accumulator -> rows row0 + 4*ty ..
// of a head's (T, 64) f32 matrix (`ld` floats a row), dims 4*tx ..; rows
// past T are skipped.
__device__ __forceinline__ void store_f32_rows(float* __restrict__ dst, size_t ld, int row0,
                                               int t, const float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * ty + r;
    if (row < t) {
      *reinterpret_cast<float4*>(dst + row * ld + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// dK and dV of 64 keys of one (image, head): grid (B*H, ceil(T / 64)).
__global__ void __launch_bounds__(kF32AttentionThreads, 1)
    f32_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, long long batch_stride,
                             long long token_stride, long long head_stride,
                             const float* __restrict__ d_out, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, long long out_batch_stride,
                             long long out_token_stride, long long out_head_stride, int t,
                             int heads, float scale) {
  extern __shared__ float4 f32_shared[];
  float* k_s = reinterpret_cast<float*>(f32_shared);
  float* v_s = k_s + kF32TileFloats;
  float* ring = v_s + kF32TileFloats;  // stage s: Q at 2s, dO at 2s + 1
  float* pt_s = ring + 4 * kF32TileFloats;
  float* dst_s = pt_s + kF32TileFloats;
  float* stats = dst_s + kF32TileFloats;  // stage s: lse[64], delta[64]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int k0 = blockIdx.y * kTile;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kTile - 1) / kTile;

  auto load_stage = [&](int stage, int tile) {
    const int q0 = tile * kTile;
    load_f32_tile_async(ring + 2 * stage * kF32TileFloats, q, ld, q0, t);
    load_f32_tile_async(ring + (2 * stage + 1) * kF32TileFloats, d_out, do_ld, q0, t);
    if (threadIdx.x < 2 * kTile) {
      const int i = threadIdx.x & (kTile - 1);
      const bool valid = q0 + i < t;
      const float* src = (threadIdx.x < kTile ? lse : delta) + (valid ? q0 + i : 0);
      cp_async_4(shared_address(stats + stage * kF32StatsFloats + threadIdx.x), src, valid);
    }
  };

  load_f32_tile_async(k_s, k, ld, k0, t);
  load_f32_tile_async(v_s, v, ld, k0, t);
  load_stage(0, 0);
  cp_async_commit();

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) load_stage((j + 1) & 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* q_t = ring + 2 * (j & 1) * kF32TileFloats;
    const float* do_t = q_t + kF32TileFloats;
    const float* lse_t = stats + (j & 1) * kF32StatsFloats;
    const float* delta_t = lse_t + kTile;

    float st[4][4], dpt[4][4];  // s^T and dP^T: rows keys 4*ty.., columns queries tx + 16c
    f32_product_nt(st, k_s, q_t, tx, ty);
    f32_product_nt(dpt, v_s, do_t, tx, ty);
    const int q0 = j * kTile;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int query = q0 + tx + 16 * c;
      const float neg_l = -lse_t[tx + 16 * c] * kLog2e, d = delta_t[tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = fast_exp2(fmaf(st[r][c], scale_log2, neg_l));
        if (query >= t || k0 + 4 * ty + r >= t) p = 0.f;
        pt_s[(4 * ty + r) * kF32Ld + tx + 16 * c] = p;
        dst_s[(4 * ty + r) * kF32Ld + tx + 16 * c] = p * (dpt[r][c] - d) * scale;
      }
    }
    __syncthreads();  // p^T and dS^T are in shared memory
    f32_product_nn(dv_acc, pt_s, do_t, tx, ty);  // dV += p^T dO
    f32_product_nn(dk_acc, dst_s, q_t, tx, ty);  // dK += dS^T q
    __syncthreads();  // everyone is done with them and with this stage
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_f32_rows(dk + out, static_cast<size_t>(out_token_stride), k0, t, dk_acc, tx, ty);
  store_f32_rows(dv + out, static_cast<size_t>(out_token_stride), k0, t, dv_acc, tx, ty);
}

// dQ of 64 queries of one (image, head): grid (B*H, ceil(T / 64)).
__global__ void __launch_bounds__(kF32AttentionThreads, 1)
    f32_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, long long batch_stride,
                            long long token_stride, long long head_stride,
                            const float* __restrict__ d_out, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dq,
                            long long out_batch_stride, long long out_token_stride,
                            long long out_head_stride, int t, int heads, float scale) {
  extern __shared__ float4 f32_shared[];
  float* q_s = reinterpret_cast<float*>(f32_shared);
  float* do_s = q_s + kF32TileFloats;
  float* ring = do_s + kF32TileFloats;  // stage s: K at 2s, V at 2s + 1
  float* ds_s = ring + 4 * kF32TileFloats;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTile;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kTile - 1) / kTile;

  auto load_stage = [&](int stage, int tile) {
    load_f32_tile_async(ring + 2 * stage * kF32TileFloats, k, ld, tile * kTile, t);
    load_f32_tile_async(ring + (2 * stage + 1) * kF32TileFloats, v, ld, tile * kTile, t);
  };

  load_f32_tile_async(q_s, q, ld, q0, t);
  load_f32_tile_async(do_s, d_out, do_ld, q0, t);
  load_stage(0, 0);
  cp_async_commit();

  float neg_l[4], d[4];  // of this thread's rows q0 + 4*ty + r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    neg_l[r] = row < t ? -lse[row] * kLog2e : 0.f;
    d[r] = row < t ? delta[row] : 0.f;
  }

  float dq_acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[r][c] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) load_stage((j + 1) & 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* k_t = ring + 2 * (j & 1) * kF32TileFloats;
    const float* v_t = k_t + kF32TileFloats;

    float s[4][4], dp[4][4];  // rows queries 4*ty.., columns keys tx + 16c
    f32_product_nt(s, q_s, k_t, tx, ty);
    f32_product_nt(dp, do_s, v_t, tx, ty);
    const int k0 = j * kTile;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool row_valid = q0 + 4 * ty + r < t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = fast_exp2(fmaf(s[r][c], scale_log2, neg_l[r]));
        if (!row_valid || k0 + tx + 16 * c >= t) p = 0.f;
        ds_s[(4 * ty + r) * kF32Ld + tx + 16 * c] = p * (dp[r][c] - d[r]) * scale;
      }
    }
    __syncthreads();  // dS is in shared memory
    f32_product_nn(dq_acc, ds_s, k_t, tx, ty);  // dQ += dS k
    __syncthreads();
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_f32_rows(dq + out, static_cast<size_t>(out_token_stride), q0, t, dq_acc, tx, ty);
}

// The three launches (delta, dK/dV, dQ) on `stream`; arguments as
// dinov2_flash_backward_f32 takes them.
inline int launch_f32_backward(const float* q, const float* k, const float* v, const float* o,
                               const float* d_out, const float* lse, float* delta, float* dq,
                               float* dk, float* dv, int b, int t, int heads,
                               long long batch_stride, long long token_stride,
                               long long head_stride, long long out_batch_stride,
                               long long out_token_stride, long long out_head_stride,
                               float scale, cudaStream_t stream) {
  const int rows = b * t * heads;
  f32_backward_delta_rows<<<(rows + kF32DeltaRows - 1) / kF32DeltaRows, kF32AttentionThreads,
                            0, stream>>>(o, d_out, delta, rows, t, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (t + kTile - 1) / kTile);
  static SharedMemoryGrant dkv_grant, dq_grant;
  err = dkv_grant(f32_attention_dkv_kernel, kF32DkvShared);
  if (err != cudaSuccess) return err;
  f32_attention_dkv_kernel<<<grid, kF32AttentionThreads, kF32DkvShared, stream>>>(
      q, k, v, batch_stride, token_stride, head_stride, d_out, lse, delta, dk, dv,
      out_batch_stride, out_token_stride, out_head_stride, t, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = dq_grant(f32_attention_dq_kernel, kF32DqShared);
  if (err != cudaSuccess) return err;
  f32_attention_dq_kernel<<<grid, kF32AttentionThreads, kF32DqShared, stream>>>(
      q, k, v, batch_stride, token_stride, head_stride, d_out, lse, delta, dq, out_batch_stride,
      out_token_stride, out_head_stride, t, heads, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2
