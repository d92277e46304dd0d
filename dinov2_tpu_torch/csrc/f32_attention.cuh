// The f32 forward attention tile loop, K4's f32 variant, shared by
// flash_attention.cu (K4, with and without lse) and, on the head views of a
// (B, T, 3D) f32 qkv slab, by slab_attention.cu (K3, K2) and slab_layer.cu
// (K1):
//
//     out[b, t, h, :] = sum_k softmax_k(scale * q[b, t, h] . k[b, k, h]) v[b, k, h]
//
// for f32 q, k, v of head_dim 64 read through three base pointers that share
// a batch, a token and a head stride (multiples of 4 elements), and a
// contiguous (B, T, H, 64) f32 output; with kWithLse also the (B, H, T) f32
// row logsumexp of the scaled scores, lse = scale * max + log(l).
//
// Replaces, for f32 activations, the Pallas TPU kernels of
// dinov2_tpu/ops/flash_attention.py (_attn_kernel_1kv, _attn_kernel) and the
// attention core of dinov2_tpu/ops/fused_attention.py (_slab_kernel,
// _head_softmax_pv), which are generic in dtype: f32 scores, an f32 softmax
// on the exact row max, and P kept in f32 for P.V (p.astype(v.dtype) is a
// no-op). The products must be f32-accurate (f32_gemm.cuh's note); here
// they run as FFMA on the CUDA cores (3xTF32 on the tensor cores, as the
// f32 GEMM and K6 f32 run, is later work: ROADMAP.md).
//
// What bounds it on an H100: 4*B*H*T^2*64 FLOP (61.5 GFLOP at B=8, T=1370,
// H=16: 0.92 ms at 67 TFLOP/s f32 against 0.05 ms for the 180 MB of
// q/k/v/out at 3.35 TB/s): operations bind it. Beside the products every
// score takes a mask, a max, an ex2 and a sum.
//
// Design. A block of 256 threads owns 64 query rows of one (image, head):
// grid (B*H, ceil(T / 64)). Q stays in shared memory; K and V tiles of 64
// keys stream through a two-stage ring filled by cp.async (16 bytes a
// thread), one tile ahead of the arithmetic. Every shared tile is row-major
// with rows padded to 68 floats. A thread (tx, ty = thread % 16, thread /
// 16) owns query rows 4*ty .. 4*ty + 3: for s = q k^T it owns keys tx, tx +
// 16, tx + 32, tx + 48 (a quarter-warp then reads eight K rows 68 floats
// apart: 32 distinct banks) and reads its Q rows as broadcasts; the row
// statistics are shuffled across the 16 lanes of a row's half-warp. The
// unnormalized probabilities go through a padded 64 x 64 shared tile to P.V,
// where the thread owns dims 4*tx .. 4*tx + 3 of its rows (V rows read as
// 16 contiguous float4 a half-warp). The softmax takes the exact running
// row max; exp is one ex2 of s * scale*log2(e) - m * scale*log2(e). The
// ragged tail is masked, never padded in memory: rows past T are zero-filled
// in shared memory, keys past T get -inf, queries past T are not written.
//
// Shared memory is dynamic: Q, two K+V stages and P, six 17 KB tiles (102
// KB: two blocks an SM).

#pragma once

#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kF32Ld = kHeadDim + 4;             // row stride of a shared f32 tile, floats
constexpr int kF32TileFloats = kTile * kF32Ld;   // a 64-row tile
constexpr int kF32AttentionThreads = 256;
constexpr int kF32ForwardShared = 6 * kF32TileFloats * 4;

// Rows r0..r0+63 of a head's (T, 64) f32 matrix (`ld` floats a row) into the
// padded shared tile dst, by all 256 threads; rows past T are zero-filled.
// The caller commits the group.
__device__ __forceinline__ void load_f32_tile_async(float* dst, const float* __restrict__ src,
                                                    size_t ld, int r0, int t) {
#pragma unroll
  for (int i = 0; i < kTile * 16 / kF32AttentionThreads; ++i) {
    const int id = threadIdx.x + i * kF32AttentionThreads;
    const int r = id >> 4, c = (id & 15) * 4;
    const bool valid = r0 + r < t;
    cp_async_16(shared_address(dst + r * kF32Ld + c),
                src + static_cast<size_t>(valid ? r0 + r : 0) * ld + c, valid);
  }
}

// acc[r][c] = sum_d a[4*ty + r][d] * b[tx + 16*c][d]: a 4 x 4 share of the
// product of two padded 64 x 64 tiles, the second one transposed.
__device__ __forceinline__ void f32_product_nt(float (&acc)[4][4], const float* a,
                                               const float* b, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[r] = *reinterpret_cast<const float4*>(a + (4 * ty + r) * kF32Ld + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * kF32Ld + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
      }
    }
  }
}

// acc[r][0..3] += sum_j p[4*ty + r][j] * b[j][4*tx .. 4*tx + 3]: a 4 x 4
// share of the product of two padded 64 x 64 tiles.
__device__ __forceinline__ void f32_product_nn(float (&acc)[4][4], const float* p,
                                               const float* b, int tx, int ty) {
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pv[r] = *reinterpret_cast<const float4*>(p + (4 * ty + r) * kF32Ld + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (j + u) * kF32Ld + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pu = u == 0 ? pv[r].x : u == 1 ? pv[r].y : u == 2 ? pv[r].z : pv[r].w;
        acc[r][0] = fmaf(pu, bv.x, acc[r][0]);
        acc[r][1] = fmaf(pu, bv.y, acc[r][1]);
        acc[r][2] = fmaf(pu, bv.z, acc[r][2]);
        acc[r][3] = fmaf(pu, bv.w, acc[r][3]);
      }
    }
  }
}

// max and sum over the 16 lanes of a half-warp, which hold one row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kWithLse>
__global__ void __launch_bounds__(kF32AttentionThreads, 2)
    f32_attention_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, long long batch_stride,
                                 long long token_stride, long long head_stride,
                                 float* __restrict__ out, float* __restrict__ lse, int t,
                                 int heads, float scale) {
  extern __shared__ float4 f32_shared[];
  float* q_s = reinterpret_cast<float*>(f32_shared);
  float* ring = q_s + kF32TileFloats;  // stage s: K at 2s, V at 2s + 1
  float* p_s = ring + 4 * kF32TileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTile;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  q += in, k += in, v += in;
  const int tiles = (t + kTile - 1) / kTile;

  load_f32_tile_async(q_s, q, ld, q0, t);
  load_f32_tile_async(ring, k, ld, 0, t);
  load_f32_tile_async(ring + kF32TileFloats, v, ld, 0, t);
  cp_async_commit();

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY, l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      float* next = ring + ((j + 1) & 1) * 2 * kF32TileFloats;
      load_f32_tile_async(next, k, ld, (j + 1) * kTile, t);
      load_f32_tile_async(next + kF32TileFloats, v, ld, (j + 1) * kTile, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of tile j has landed
    __syncthreads();     // everyone's has
    const float* k_s = ring + (j & 1) * 2 * kF32TileFloats;
    const float* v_s = k_s + kF32TileFloats;

    float s[4][4];
    f32_product_nt(s, q_s, k_s, tx, ty);
    const int k0 = j * kTile;
    if (k0 + kTile > t) {  // the last tile: mask the keys past T
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (k0 + tx + 16 * c >= t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) s[r][c] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // every tile holds a key below T, so the new maximum is finite
      const float m_new = fmaxf(m_run[r], row_max16(fmaxf(fmaxf(s[r][0], s[r][1]),
                                                          fmaxf(s[r][2], s[r][3]))));
      const float alpha = fast_exp2((m_run[r] - m_new) * scale_log2);
      const float neg_m = -m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = fast_exp2(fmaf(s[r][c], scale_log2, neg_m));
        sum += p;
        p_s[(4 * ty + r) * kF32Ld + tx + 16 * c] = p;
      }
      l_run[r] = l_run[r] * alpha + row_sum16(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // P is in shared memory
    f32_product_nn(acc, p_s, v_s, tx, ty);
    __syncthreads();  // everyone is done with P and with this stage
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= t) continue;
    const float inv = 1.f / l_run[r];
    *reinterpret_cast<float4*>(
        out + ((static_cast<size_t>(img) * t + row) * heads + head) * kHeadDim + 4 * tx) =
        make_float4(acc[r][0] * inv, acc[r][1] * inv, acc[r][2] * inv, acc[r][3] * inv);
    if (kWithLse && tx == 0) {
      lse[static_cast<size_t>(blockIdx.x) * t + row] =
          m_run[r] * scale + logf(fmaxf(l_run[r], 1e-30f));
    }
  }
}

template <bool kWithLse>
int launch_f32_forward(const float* q, const float* k, const float* v, float* out, float* lse,
                       int b, int t, int heads, long long batch_stride, long long token_stride,
                       long long head_stride, float scale, cudaStream_t stream) {
  auto kernel = f32_attention_forward_kernel<kWithLse>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kF32ForwardShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * heads, (t + kTile - 1) / kTile), kF32AttentionThreads, kF32ForwardShared,
           stream>>>(q, k, v, batch_stride, token_stride, head_stride, out, lse, t, heads, scale);
  return cudaGetLastError();
}

// The f32 attention output (B, T, D) of a (B, T, 3D) f32 qkv slab: the loop
// above on the slab's head views, q, k and v at column offsets h*64, D + h*64
// and 2D + h*64. One launch on s.
inline cudaError_t launch_f32_slab_attention(const float* qkv, float* out, int b, int t, int d,
                                             int heads, float scale, cudaStream_t s) {
  const long long token_stride = 3LL * d;
  return static_cast<cudaError_t>(launch_f32_forward<false>(
      qkv, qkv + d, qkv + 2 * d, out, nullptr, b, t, heads, t * token_stride, token_stride,
      kHeadDim, scale, s));
}

}  // namespace
}  // namespace dinov2
